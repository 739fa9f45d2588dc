"""Port parity for the encoder-decoder family (whisper-large-v3: the
bidirectional encoder over stub frame embeddings, the causal decoder with
cross-attention) on the CPU.  The config field by field, the full-width
init tree against `jax.eval_shape` of the reference's (shapes and dtypes),
the converter on the stacked enc / dec trees, `layer_norm`, `gelu_mlp`
and `sinusoid_positions` against the reference, and the `reduced()` model
from the reference's init on the same numpy inputs (24 frames): forward,
prefill, loss, gradients (the frames' too) and 8 decode steps after
`prefill_cross`, in f32 and bf16; the attention routes (the decoder's
self-attention on `ops.flash_attention`, never the encoder or the
cross-attention); the batch struct with its frames, the synthetic batch,
the prefill step and one Regime-B resident round through
`launch.train.Trainer` against the reference trainer's round."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.configs import SHAPES as JSHAPES
from repro.launch import steps as jsteps
from repro.models import encdec as jenc
from repro.models import layers as JL
from repro.models import prefill_logits as jprefill_logits
from repro.spec import make_algo_spec as jmake_spec
from repro_torch import configs, convert, models, tree
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tenc
from repro_torch.models import layers as TL

torch.set_num_threads(2)
ARCH = "whisper-large-v3"
# leaves of the reference's full-width init (jax.eval_shape of
# repro.models.encdec.init_params); param_count() says 1,600,783,360 (its
# formula leaves out the LayerNorms and the MLP biases)
LEAVES = 1_601_607_680
PARAM_COUNT = 1_600_783_360
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


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the config and the layers
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
    assert api.decode_step is tenc.decode_step
    assert api.init_cache is tenc.init_cache
    # the decoder self-attention's shape at full width: hd 64, a group of 1
    assert (tc.n_heads, tc.n_kv_heads, tc.hd) == ((20, 20, 64) if
                                                  which == "full" else
                                                  (4, 4, 32))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(cdtype):
    x = _rand(1, 2, 5, 48) * 4 + 2
    w, b = _rand(2, 48), _rand(3, 48)
    dt = getattr(torch, cdtype)
    got = TL.layer_norm(*(torch.as_tensor(a).to(dt) for a in (x, w, b)))
    want = JL.layer_norm(*(jnp.asarray(a).astype(cdtype) for a in (x, w, b)))
    assert got.dtype == dt
    if cdtype == "float32":
        np.testing.assert_allclose(_t2np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(_t2np(got), _np(want))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(cdtype):
    # the tanh form of GELU (jax.nn.gelu's default), with both biases
    g = torch.Generator().manual_seed(4)
    p = TL.init_gelu_mlp(g, 48, 96)
    p["b1"] = torch.randn(96, generator=g)
    p["b2"] = torch.randn(48, generator=g)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (48, 96), "b1": (96,), "w2": (96, 48), "b2": (48,)}
    x = _rand(5, 2, 7, 48)
    dt = getattr(torch, cdtype)
    got = TL.gelu_mlp(p, torch.as_tensor(x).to(dt))
    want = _run(JL.gelu_mlp, {k: jnp.asarray(v.numpy()) for k, v in
                              p.items()}, jnp.asarray(x).astype(cdtype))
    assert got.dtype == dt
    _check(got, want, TOL[cdtype])
    exact = torch.nn.functional.gelu(torch.as_tensor(x[0, 0]))
    assert not torch.equal(exact, torch.nn.functional.gelu(
        torch.as_tensor(x[0, 0]), approximate="tanh"))
    lead = TL.init_gelu_mlp(g, 8, 16, lead=(3,))
    assert tuple(lead["w2"].shape) == (3, 16, 8)
    assert tuple(lead["b1"].shape) == (3, 16)


def _angle_ulps(pos: int) -> float:
    """Two f32 ulps of the largest angle (pos * div, div <= 1): XLA's
    and torch's f32 exp may part by an ulp in div, which moves the angle
    and so sin and cos by up to an ulp of the angle (1.2e-4 at 1,499)."""
    return 2 * float(np.spacing(np.float32(max(pos, 1))))


@pytest.mark.parametrize("n,dim", [(24, 128), (1500, 1280), (7, 6)])
def test_sinusoid_positions_match_reference(n, dim):
    got = TL.sinusoid_positions(n, dim)
    want = np.asarray(JL.sinusoid_positions(n, dim))
    assert got.dtype == torch.float32 and got.shape == (n, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_angle_ulps(n - 1))


@pytest.mark.parametrize("pos", [0, 5, 4095])
def test_decode_position_embedding_matches_reference(pos):
    # the decode step's own sinusoid at one position, as the reference's
    # decode_step computes it (the f32 log of 10^4 over d)
    d = 1280
    div = jnp.exp(jnp.arange(0, d, 2, dtype=jnp.float32)
                  * (-jnp.log(10000.0) / d))
    ang = jnp.asarray(pos, jnp.float32) * div
    want = jnp.zeros((d,), jnp.float32).at[0::2].set(jnp.sin(ang)).at[
        1::2].set(jnp.cos(ang))
    got = tenc._position_embedding(pos, d, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_angle_ulps(pos))


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------
def test_full_width_init_tree_matches_reference():
    # shapes and dtypes only: the reference's init through jax.eval_shape,
    # the port's under FakeTensorMode (no memory behind either)
    jc, tc = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jenc.init_params(k, jc),
                            jax.random.PRNGKey(0))
    want = [(_jkey(path), (tuple(leaf.shape), str(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    with FakeTensorMode():
        own = tenc.init_params(torch.Generator(), tc, device="cpu")
        got = [(p, (tuple(t.shape), str(t.dtype).split(".")[-1]))
               for p, t in tree.paths(own)]
    assert got == want
    n = sum(int(np.prod(s)) for _, (s, _) in got)
    assert n == LEAVES
    assert tc.param_count() == PARAM_COUNT and n - PARAM_COUNT == 824_320
    assert dict(got)[("dec_layers", "self_attn", "wq")][0] == (32, 1280,
                                                               1280)
    assert dict(got)[("enc_layers", "mlp", "w1")][0] == (32, 1280, 5120)


@functools.lru_cache(maxsize=None)
def _reference_init():
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    init = jax.jit(jenc.init_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg_j))
    # the reference's biases and LayerNorm offsets start at zero: give
    # them values, so that the comparisons reach them
    rng = np.random.default_rng(9)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                      if _jkey(p)[-1] in ("b", "b1", "b2") else a), jp)
    return jp, convert.params_from_reference(jp), cfg_j, cfg_t


def test_params_from_reference_carries_the_stacked_trees():
    jp, tp, _, cfg_t = _reference_init()
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = list(tree.paths(tp))
    assert [p for p, _ in got] == [_jkey(p) for p, _ in jpaths]
    for (_, t), (path, leaf) in zip(got, jpaths):
        assert np.array_equal(t.numpy(), leaf), path
    assert set(tp["dec_layers"]) == {"ln1", "self_attn", "ln_x",
                                     "cross_attn", "ln2", "mlp"}
    own = tenc.init_params(torch.Generator().manual_seed(0), cfg_t,
                           device="cpu")
    assert [(p, tuple(v.shape), v.dtype) for p, v in tree.paths(own)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in got]
    layers = TL.unstack(tp["enc_layers"])
    assert len(layers) == cfg_t.n_enc_layers
    assert torch.equal(layers[1]["mlp"]["w1"], tp["enc_layers"]["mlp"]["w1"][1])


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    return ({"tokens": torch.as_tensor(tokens).long(),
             "labels": torch.as_tensor(labels).long(),
             "frames": torch.as_tensor(frames)},
            {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             "frames": jnp.asarray(frames)})


def _cfgs(cdtype):
    jp, tp, cfg_j, cfg_t = _reference_init()
    return (jp, tp, cfg_j.replace(compute_dtype=cdtype),
            cfg_t.replace(compute_dtype=cdtype))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_reduced_model_matches_reference(cdtype):
    jp, tp, cfg_j, cfg_t = _cfgs(cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t)
    enc = tenc.encode(tp, tbatch["frames"], cfg_t)
    _check(enc, _run(lambda p, f: jenc.encode(p, f, cfg_j), jp,
                     jbatch["frames"]), tol, "encoder")
    want = _run(lambda p, b: jenc.forward_train(p, b, cfg_j), jp, jbatch)
    got = tenc.forward_train(tp, tbatch, cfg_t)
    assert got.dtype == cfg_t.cdtype and got.shape == (2, S, cfg_t.vocab)
    _check(got, want, tol, "logits")
    jpre = _run(lambda p, b: jprefill_logits(p, b, cfg_j), jp, jbatch)
    pre = models.prefill_logits(tp, tbatch, cfg_t)
    assert pre.shape == (2, 1, cfg_t.vocab)
    _check(pre, jpre, tol, "prefill")
    jloss = _run(lambda p, b: jenc.loss_fn(p, b, cfg_j), jp, jbatch)
    loss = models.get_model(cfg_t).loss_fn(tp, tbatch, cfg_t)
    np.testing.assert_allclose(_t2np(loss), _np(jloss), rtol=tol["loss"],
                               atol=tol["loss"])


def test_forward_routes(monkeypatch):
    # the kernel route reaches ops.flash_attention once per decoder layer
    # at the decoder's (B, S, H, hd), never for the encoder or the
    # cross-attention; the plain route never; the two agree in f32
    _, tp, _, cfg = _reference_init()
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    tbatch, _ = _batch(cfg)
    kern = tenc.forward_train(tp, tbatch, cfg)
    assert calls == [(2, S, 4, 32)] * cfg.n_layers
    calls.clear()
    plain = tenc.forward_train(tp, tbatch, cfg, route="plain")
    assert not calls
    torch.testing.assert_close(kern, plain, rtol=1e-5, atol=1e-5)
    tenc.loss_fn(tp, tbatch, cfg)
    cache = tenc.prefill_cross(tp, tbatch["frames"], cfg,
                               tenc.init_cache(cfg, 2, 8, device="cpu"))
    tenc.decode_step(tp, cache, tbatch["tokens"][:, :1], 0, cfg)
    assert not calls
    with pytest.raises(ValueError, match="route"):
        tenc.forward_train(tp, tbatch, cfg, route="auto")


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_loss_gradient_matches_reference(cdtype):
    # torch.func.grad of the port's loss (the plain route) against
    # jax.grad of the reference's, every leaf and the frames' gradient
    jp, tp, cfg_j, cfg_t = _cfgs(cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t, seed=3)
    jg, jgf = _run(lambda p, f: jax.grad(lambda p, f: jenc.loss_fn(
        p, dict(jbatch, frames=f), cfg_j), argnums=(0, 1))(p, f), jp,
        jbatch["frames"])
    tg, tgf = torch.func.grad(lambda p, f: tenc.loss_fn(
        p, dict(tbatch, frames=f), cfg_t), argnums=(0, 1))(
            tp, tbatch["frames"])
    for p, x in jax.tree_util.tree_flatten_with_path(jg)[0] + [((), jgf)]:
        _check(tree.get(tg, _jkey(p)) if p else tgf, x, tol, str(p))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_decode_matches_reference(cdtype):
    # prefill_cross, then 8 steps: logits every step, every cache leaf at
    # the end
    jp, tp, cfg_j, cfg_t = _cfgs(cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t, seed=8)
    tokens = tbatch["tokens"].numpy()
    tc = models.get_model(cfg_t).init_cache(cfg_t, 2, 12, device="cpu")
    tc = tenc.prefill_cross(tp, tbatch["frames"], cfg_t, tc)
    jc = _run(lambda p, f, c: jenc.prefill_cross(p, f, cfg_j, c), jp,
              jbatch["frames"], jenc.init_cache(cfg_j, 2, 12))
    for name in ("xk", "xv"):
        assert tc[name].shape == (2, 2, 24, 4, 32)
        _check(tc[name], jc[name], tol, name)
    step = jax.jit(lambda p, c, t, pos: jenc.decode_step(p, c, t, pos,
                                                          cfg_j),
                   compiler_options=EXACT)
    for pos in range(8):
        tok = tokens[:, pos:pos + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32), pos)
        tl, tc = tenc.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                  cfg_t)
        assert tl.shape == (2, 1, cfg_t.vocab) and tl.dtype == cfg_t.cdtype
        _check(tl, jl, tol, f"logits pos {pos}")
    assert set(tc) == set(jc)
    for name in tc:
        assert tc[name].dtype == cfg_t.cdtype
        _check(tc[name], jc[name], tol, name)


def test_decode_does_not_modify_the_cache_passed_in():
    _, tp, _, cfg = _reference_init()
    cache = tenc.init_cache(cfg, 2, 12, device="cpu")
    before = tree.tree_map(lambda t: t.clone(), cache)
    _, new = tenc.decode_step(tp, cache, torch.ones((2, 1),
                                                    dtype=torch.long), 3, cfg)
    for name, t in cache.items():
        assert torch.equal(t, before[name])
    assert not torch.equal(new["k"], cache["k"])
    assert new["xk"] is cache["xk"]


# ---------------------------------------------------------------------------
# launch: structs, the synthetic batch, the prefill step, a round
# ---------------------------------------------------------------------------
def test_batch_struct_matches_reference():
    cfg_j, cfg_t = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    jb = jsteps.batch_struct(cfg_j, JSHAPES["prefill_32k"], (4, 2))
    tb = tsteps.batch_struct(cfg_t, configs.SHAPES["prefill_32k"], (4, 2))
    assert set(tb) == set(jb) == {"frames", "tokens", "labels"}
    for name in jb:
        assert tuple(tb[name].shape) == jb[name].shape, name
        assert tb[name].device.type == "meta"
    assert tuple(tb["frames"].shape) == (4, 2, 1500, 1280)
    assert tb["frames"].dtype == torch.float32
    jd = jsteps.input_specs(cfg_j, JSHAPES["decode_32k"], jsteps.Layout(
        ("data",), (), ("model",), (), 2, 4))
    td = tsteps.input_specs(cfg_t, configs.SHAPES["decode_32k"],
                            tsteps.Layout(("data",), (), ("model",), (), 2,
                                          4))
    assert {k: tuple(v.shape) for k, v in td["cache"].items()} == \
        {k: v.shape for k, v in jd["cache"].items()}


def test_synth_lm_batch_draws_frames():
    cfg = configs.get_reduced(ARCH)
    b = ttrain.synth_lm_batch(torch.Generator().manual_seed(0), cfg,
                              (3, 1, 2), 16)
    assert set(b) == {"tokens", "labels", "frames"}
    assert tuple(b["frames"].shape) == (3, 1, 2, 24, 128)
    assert b["frames"].dtype == torch.float32
    assert torch.equal(b["labels"][..., :-1], b["tokens"][..., 1:])
    again = ttrain.synth_lm_batch(torch.Generator().manual_seed(0), cfg,
                                  (3, 1, 2), 16)
    assert torch.equal(again["frames"], b["frames"])


def test_prefill_step_takes_the_whole_batch():
    # build_prefill_step hands each client its tokens and frames; against
    # the reference's vmapped step, f32
    m, B = 2, 2
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    jp = jax.vmap(lambda k: jenc.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(1), m))
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp))
    shape = dataclasses.replace(configs.SHAPES["prefill_32k"], seq_len=S,
                                global_batch=m * B)
    jshape = dataclasses.replace(JSHAPES["prefill_32k"], seq_len=S,
                                 global_batch=m * B)
    step, _, _, args = tsteps.build_prefill_step(
        cfg_t, None, tmesh.one_device_layout(m, B), shape)
    assert set(args[1]) == {"tokens", "frames"}
    jstep = jsteps.build_prefill_step(
        cfg_j, jax.make_mesh((1, 1), ("data", "model")),
        jsteps.Layout(("data",), (), ("model",), (), m, B), jshape)[0]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg_t.vocab, (m, B, S))
    fr = rng.standard_normal((m, B, cfg_t.n_frames, cfg_t.d_model)).astype(
        np.float32)
    got = step(tp, {"tokens": torch.as_tensor(toks),
                    "frames": torch.as_tensor(fr)})
    want = jstep(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                      "frames": jnp.asarray(fr)})
    assert got.shape == want.shape == (m, B, 1, cfg_t.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_trainer_resident_round_matches_reference():
    # one resident round of launch.train.Trainer (ring topology, the same
    # tables on both sides) from the reference's stacked init, against the
    # reference's build_train_algo round on the same batches: every state
    # leaf at the Regime-B tolerance (rtol 1e-4, atol 2e-5) but the
    # momentum, the round's gradient, held as the gradients above (TOL)
    M, B = 4, 2
    ap = ttrain.build_parser()
    args = ap.parse_args(["--arch", ARCH, "--reduced", "--clients", str(M),
                          "--batch", str(B), "--seq", str(S), "--resident",
                          "--topology", "ring", "--device", "cpu"])
    run = ttrain.Trainer(args, ap)
    cfg_j = jconfigs.get_reduced(ARCH)
    spec = jmake_spec("dfedpgp", topology="ring", n_neighbors=2, seed=0,
                      gossip="matrix", resident=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), M, B)
    ja, _, _, jfl = jsteps.build_train_algo(cfg_j, None, lay, spec=spec,
                                            lr=0.02)
    stacked = jax.vmap(lambda k: jenc.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(0), M))
    sj, jfl = ja.init_flat(stacked, jfl)
    # dec_norm is personal, as lm_head
    assert set(jax.tree.leaves(jax.tree.map(lambda _: 1, sj.personal))) \
        == {1}
    run.state = convert.flat_state_from_reference(
        flat=np.asarray(sj.flat), personal=jax.tree.map(np.asarray,
                                                        sj.personal),
        mu=np.asarray(sj.mu), mom_u=np.asarray(sj.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, sj.opt_v.momentum),
        round=np.asarray(sj.round))
    assert set(run.state.personal) == {"dec_norm", "lm_head"}
    np.testing.assert_array_equal(run.state.flat.numpy(), np.asarray(sj.flat))
    Pj = spec.schedule(M).at(0)
    P, _ = run.topology(0)
    np.testing.assert_array_equal(P.idx.numpy(), np.asarray(Pj.idx))
    rng = np.random.default_rng(12)
    F, D = cfg_j.n_frames, cfg_j.d_model
    bj, bt = {}, {}
    for k in "vu":
        t = rng.integers(0, cfg_j.vocab, (M, 1, B, S)).astype(np.int32)
        f = rng.standard_normal((M, 1, B, F, D)).astype(np.float32)
        bj[k] = {"tokens": jnp.asarray(t), "labels": jnp.asarray(
            np.roll(t, -1, -1)), "frames": jnp.asarray(f)}
        bt[k] = {"tokens": torch.as_tensor(t).long(), "labels":
                 torch.as_tensor(np.roll(t, -1, -1)).long(),
                 "frames": torch.as_tensor(f)}
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


def test_train_main_runs_whisper():
    # python -m repro_torch.launch.train --arch whisper-large-v3 --reduced
    # on the CPU: finite losses through the stated plain route
    state = ttrain.main(["--arch", ARCH, "--reduced", "--rounds", "1",
                         "--clients", "2", "--batch", "1", "--seq", "8",
                         "--neighbors", "1", "--resident", "--device", "cpu"])
    assert torch.isfinite(state.flat).all()
