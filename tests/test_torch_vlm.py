"""Port parity for the VLM family (the Qwen2-VL backbone, M-RoPE) on the
CPU: the config field by field, the full-width init tree against
`jax.eval_shape` of the reference's (shapes only), `build_positions` and
`apply_mrope` against the reference's, and the `reduced()` model from the
reference's init on the same numpy tokens and vision embeddings: forward,
prefill, loss, gradients and 8 text-only decode steps in f32 and bf16;
the batch structs, the synthetic batch, the prefill step and one
Regime-B resident round through `launch.train.Trainer`.

Attention in the forward runs `flash_attention`'s plain version here; the
CUDA kernel runs only on a GPU, where `chip_smoke.py` holds it and the
model against these plain versions."""
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
from repro.models import layers as JL
from repro.models import prefill_logits as jprefill_logits
from repro.models import vlm as jvlm
from repro.spec import make_algo_spec as jmake_spec
from repro_torch import configs, convert, models, tree
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import vlm as tvlm

torch.set_num_threads(2)
ARCH = "qwen2-vl-7b"
# leaves of the reference's full-width init (jax.eval_shape of
# repro.models.vlm.init_params, which is dense.init_params)
LEAVES = 7_615_616_512
# as tests/test_torch_dense.py
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
# config, init, conversion
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
    assert tc.hd == jc.hd and tc.param_count() == jc.param_count()
    assert sum(tc.mrope_sections) == tc.hd // 2
    api = models.get_model(tc)
    assert api.decode_step is tvlm.decode_step
    assert api.init_params is tvlm.init_params


def test_full_width_init_tree_matches_reference():
    # shapes only: no memory behind either side.  What the attention
    # kernel sees at full width: 28 heads on 4 KV heads (a group of 7) at
    # hd 128
    jc, tc = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    assert (tc.n_heads, tc.n_kv_heads, tc.hd) == (28, 4, 128)
    shapes = jax.eval_shape(lambda k: jvlm.init_params(k, jc),
                            jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with FakeTensorMode():
        own = tvlm.init_params(torch.Generator(), tc, device="cpu")
        got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in _paths(own)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == LEAVES


@functools.lru_cache(maxsize=None)
def _reference_init():
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    init = jax.jit(jvlm.init_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), cfg_j))
    return jp, convert.params_from_reference(jp), cfg_j, cfg_t


def test_params_from_reference_carries_the_vlm_tree():
    jp, tp, _, cfg_t = _reference_init()
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jpaths) == len(list(_paths(tp)))
    for path, leaf in jpaths:
        t = tree.get(tp, tuple(k.key for k in path))
        assert np.array_equal(t.numpy(), leaf), path
    assert "bq" in tp["layers"]["attn"]
    own = tvlm.init_params(torch.Generator().manual_seed(0), cfg_t,
                           device="cpu")
    assert {p: (tuple(v.shape), v.dtype) for p, v in _paths(own)} == \
        {p: (tuple(v.shape), v.dtype) for p, v in _paths(tp)}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_vis,n_text,start", [(16, 24, 0), (1024, 7, 0),
                                                (10, 5, 0), (1, 3, 0),
                                                (0, 9, 0), (0, 9, 5)])
def test_build_positions_matches_reference_bitwise(n_vis, n_text, start):
    got = tvlm.build_positions(n_vis, n_text, start)
    want = np.asarray(jvlm.build_positions(n_vis, n_text, start))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# (hd, sections): the reduced and full configs' splits, a split short of
# hd/2 (the last stream pads it) and one past it (truncated)
MROPE = {"reduced": (32, (4, 6, 6)), "full": (128, (16, 24, 24)),
         "short": (32, (4, 4, 4)), "long": (32, (8, 8, 8))}


@pytest.mark.parametrize("case", sorted(MROPE))
def test_apply_mrope_matches_reference(case):
    # f32 angles and products on both sides: within 1e-6 of the values'
    # scale, the stream each slot reads exactly the reference's
    hd, sections = MROPE[case]
    want_sec = np.asarray(jnp.repeat(jnp.arange(3), jnp.asarray(sections),
                                     total_repeat_length=hd // 2))
    np.testing.assert_array_equal(TL.mrope_streams(hd, sections).numpy(),
                                  want_sec)
    rng = np.random.default_rng(hd + len(case))
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos = np.asarray(jvlm.build_positions(25, 15))[:, None, :]
    pos = np.broadcast_to(pos, (3, 2, 40)).copy()
    pos[2, 1] += 3                                   # the streams differ
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections,
                         1e6)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                     sections, 1e6))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=24, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    vision = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return ({"tokens": torch.as_tensor(tokens).long(),
             "labels": torch.as_tensor(labels).long(),
             "vision": torch.as_tensor(vision)},
            {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             "vision": jnp.asarray(vision)})


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_reduced_model_matches_reference(cdtype):
    # 16 vision embeddings and 24 text tokens: logits at the text
    # positions, the prefill's at the last one, the loss
    jp, tp, cfg_j, cfg_t = _reference_init()
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    tbatch, jbatch = _batch(cfg_t)
    got = tvlm.forward_train(tp, tbatch, cfg_t)
    want = jax.jit(jvlm.forward_train, static_argnums=(2,))(jp, jbatch, cfg_j)
    assert got.dtype == cfg_t.cdtype and got.shape == (2, 24, cfg_t.vocab)
    _check(got, want, tol, "logits")
    pre = models.prefill_logits(tp, tbatch, cfg_t)
    assert pre.shape == (2, 1, cfg_t.vocab)
    _check(pre, jprefill_logits(jp, jbatch, cfg_j), tol, "prefill")
    loss = models.get_model(cfg_t).loss_fn(tp, tbatch, cfg_t)
    np.testing.assert_allclose(_t2np(loss), _np(jvlm.loss_fn(jp, jbatch,
                                                             cfg_j)),
                               rtol=tol["loss"], atol=tol["loss"])


def test_forward_routes(monkeypatch):
    # the kernel route reaches ops.flash_attention once a layer, the plain
    # route never; the two agree in f32
    _, tp, _, cfg = _reference_init()
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    tbatch, _ = _batch(cfg)
    kern = tvlm.forward_train(tp, tbatch, cfg)
    assert calls == [(2, 40, 4, 32)] * cfg.n_layers
    calls.clear()
    plain = tvlm.forward_train(tp, tbatch, cfg, route="plain")
    assert not calls
    torch.testing.assert_close(kern, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_loss_gradient_matches_reference(cdtype):
    # the training route's autograd gradient against jax.grad of the
    # reference's loss, every leaf: f32 at rtol 1e-4 / atol 1e-6 (as the
    # dense family), bf16 to the LM bound; the vision embeddings' gradient
    # too (the stub encoder's output)
    jp, tp, cfg_j, cfg_t = _reference_init()
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tbatch, jbatch = _batch(cfg_t, seed=3)
    jg, jgv = jax.jit(jax.grad(lambda p, v: jvlm.loss_fn(
        p, dict(jbatch, vision=v), cfg_j), argnums=(0, 1)))(
            jp, jbatch["vision"])
    tg, tgv = torch.func.grad(lambda p, v: tvlm.loss_fn(
        p, dict(tbatch, vision=v), cfg_t), argnums=(0, 1))(
            tp, tbatch["vision"])
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    for p, x in leaves + [((), jgv)]:
        got = tree.get(tg, tuple(k.key for k in p)) if p else tgv
        if cdtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(x),
                                       rtol=1e-4, atol=1e-6, err_msg=str(p))
        else:
            _check(got, x, TOL[cdtype], str(p))


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_text_only_decode_matches_reference(cdtype):
    # 8 text-only steps, all three position streams at pos: logits every
    # step, the cache at the end
    jp, tp, cfg_j, cfg_t = _reference_init()
    cfg_j = cfg_j.replace(compute_dtype=cdtype)
    cfg_t = cfg_t.replace(compute_dtype=cdtype)
    tol = TOL[cdtype]
    tokens = np.random.default_rng(7).integers(0, cfg_t.vocab, (2, 8))
    tc = models.get_model(cfg_t).init_cache(cfg_t, 2, 12, device="cpu")
    jc = jvlm.init_cache(cfg_j, 2, 12)
    step = jax.jit(jvlm.decode_step, static_argnums=(4,))
    for pos in range(8):
        tok = tokens[:, pos:pos + 1]
        tl, tc = tvlm.decode_step(tp, tc, torch.as_tensor(tok).long(), pos,
                                  cfg_t)
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32), pos, cfg_j)
        assert tl.shape == (2, 1, cfg_t.vocab) and tl.dtype == cfg_t.cdtype
        _check(tl, jl, tol, f"logits pos {pos}")
    for name in ("k", "v"):
        _check(tc[name], jc[name], tol, name)


# ---------------------------------------------------------------------------
# launch: structs, the synthetic batch, the prefill step, a round
# ---------------------------------------------------------------------------
def test_batch_struct_matches_reference():
    cfg_j, cfg_t = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    jb = jsteps.batch_struct(cfg_j, JSHAPES["prefill_32k"], (4, 2))
    tb = tsteps.batch_struct(cfg_t, configs.SHAPES["prefill_32k"], (4, 2))
    assert set(tb) == set(jb) == {"tokens", "vision", "labels"}
    for name in jb:
        assert tuple(tb[name].shape) == jb[name].shape, name
        assert tb[name].device.type == "meta"
    assert tuple(tb["tokens"].shape) == (4, 2, 32_768 - 1024)
    assert tb["vision"].dtype == torch.float32


def test_synth_lm_batch_draws_vision_embeddings():
    cfg = configs.get_reduced(ARCH)
    b = ttrain.synth_lm_batch(torch.Generator().manual_seed(0), cfg,
                              (3, 1, 2), 16)
    assert tuple(b["vision"].shape) == (3, 1, 2, 16, 128)
    assert b["vision"].dtype == torch.float32
    assert torch.equal(b["labels"][..., :-1], b["tokens"][..., 1:])
    again = ttrain.synth_lm_batch(torch.Generator().manual_seed(0), cfg,
                                  (3, 1, 2), 16)
    assert torch.equal(again["vision"], b["vision"])


def test_prefill_step_takes_the_whole_batch():
    # build_prefill_step hands each client its tokens and vision
    # embeddings; against the reference's vmapped step, f32
    m, B, S = 2, 2, 24
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    nv = cfg_t.n_vision_tokens
    jp = jax.vmap(lambda k: jvlm.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(1), m))
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp))
    shape = dataclasses.replace(configs.SHAPES["prefill_32k"],
                                seq_len=S + nv, global_batch=m * B)
    jshape = dataclasses.replace(JSHAPES["prefill_32k"], seq_len=S + nv,
                                 global_batch=m * B)
    step, _, _, args = tsteps.build_prefill_step(
        cfg_t, None, tmesh.one_device_layout(m, B), shape)
    assert set(args[1]) == {"tokens", "vision"}
    jstep = jsteps.build_prefill_step(
        cfg_j, jax.make_mesh((1, 1), ("data", "model")),
        jsteps.Layout(("data",), (), ("model",), (), m, B), jshape)[0]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg_t.vocab, (m, B, S))
    vis = rng.standard_normal((m, B, nv, cfg_t.d_model)).astype(np.float32)
    got = step(tp, {"tokens": torch.as_tensor(toks),
                    "vision": torch.as_tensor(vis)})
    want = jstep(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                      "vision": jnp.asarray(vis)})
    assert got.shape == want.shape == (m, B, 1, cfg_t.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_trainer_resident_round_matches_reference():
    # one resident round of launch.train.Trainer (ring topology, the same
    # tables on both sides) from the reference's stacked init, against the
    # reference's build_train_algo round on the same batches; every leaf
    # at the Regime-B tolerance (rtol 1e-4, atol 2e-5)
    M, B, S = 4, 2, 24
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
    stacked = jax.vmap(lambda k: jvlm.init_params(k, cfg_j))(
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
    rng = np.random.default_rng(12)
    nv, D = cfg_j.n_vision_tokens, cfg_j.d_model
    bj, bt = {}, {}
    for k in "vu":
        t = rng.integers(0, cfg_j.vocab, (M, 1, B, S)).astype(np.int32)
        v = rng.standard_normal((M, 1, B, nv, D)).astype(np.float32)
        bj[k] = {"tokens": jnp.asarray(t), "labels": jnp.asarray(
            np.roll(t, -1, -1)), "vision": jnp.asarray(v)}
        bt[k] = {"tokens": torch.as_tensor(t).long(), "labels":
                 torch.as_tensor(np.roll(t, -1, -1)).long(),
                 "vision": torch.as_tensor(v)}
    mt, _, _ = run.step(0, bt)
    sj, mj = jax.jit(lambda s, P, b: ja.round_fn_flat(s, P, b, jfl))(
        sj, Pj, bj)
    np.testing.assert_allclose(float(mt["loss_u"]), float(mj["loss_u"]),
                               rtol=1e-5)
    st = run.state
    np.testing.assert_allclose(st.flat.numpy(), np.asarray(sj.flat),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(st.opt_u.momentum.numpy(),
                               np.asarray(sj.opt_u.momentum), rtol=1e-4,
                               atol=2e-5)
    for p, x in jax.tree_util.tree_flatten_with_path(sj.personal)[0]:
        np.testing.assert_allclose(
            tree.get(st.personal, tuple(k.key for k in p)).numpy(),
            np.asarray(x), rtol=1e-4, atol=2e-5, err_msg=str(p))
    np.testing.assert_array_equal(st.mu.numpy(), np.asarray(sj.mu))


def test_train_main_runs_the_vlm():
    # python -m repro_torch.launch.train --arch qwen2-vl-7b --reduced on
    # the CPU: finite losses through the stated plain route
    state = ttrain.main(["--arch", ARCH, "--reduced", "--rounds", "1",
                         "--clients", "2", "--batch", "1", "--seq", "8",
                         "--neighbors", "1", "--resident", "--device", "cpu"])
    assert torch.isfinite(state.flat).all()
