"""Port parity of checkpoints (`repro_torch.checkpoint`), the optimizer's
helpers and `serve.from_checkpoint`, against the JAX reference
(`repro.checkpoint`, `repro.optim`, `repro.serve`).

Files move both ways: a reference-written npz of a `FlatDFedPGPState`
(with and without codec memory) and of an `AsyncState` + its profile loads
into the port bit for bit, and the next round (ticks) then match the
reference's; a port-written npz loads in the reference's `load_pytree`
with equal arrays.  The key sets are the reference's (tree paths joined by
"/", None leaves skipped).  bf16 leaves keep their bits both ways."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as jcompress
from repro.checkpoint import checkpoint as jckpt
from repro.core import dfedpgp as jdfedpgp
from repro.core import partition as jpartition
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.hetero import profiles as jprofiles
from repro.hetero.runtime import AsyncRuntime as JAsyncRuntime
from repro.models import cnn as jcnn
from repro.optim import SGD as JSGD
from repro.optim import clip_by_global_norm as jclip
from repro.serve import state as jserve_state
from repro_torch import checkpoint as tckpt
from repro_torch import compress as tcompress
from repro_torch import convert, tree
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import partition as tpartition
from repro_torch.core.topology import SparseTopology
from repro_torch.hetero import profiles as tprofiles
from repro_torch.hetero.runtime import AsyncRuntime
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGD as TSGD
from repro_torch.optim import SGDState as TSGDState
from repro_torch.optim import clip_by_global_norm, exp_decay_schedule
from repro_torch.serve import state as tserve_state

torch.set_num_threads(2)
# a small CNN: two narrow conv layers
CFG_J = jcnn.CNNConfig(widths=(4, 8), d_feature=16, gn_groups=2)
CFG_T = tcnn.CNNConfig(widths=(4, 8), d_feature=16, gn_groups=2)
M = 8
# The resumed round (ticks) of each engine from the same restored state:
# the resident-round bound of
# test_torch_dfedpgp.py::test_round_fn_flat_three_rounds_match_reference
# (XLA:CPU and oneDNN sum convs / GroupNorm / matmuls in other orders).
RTOL, ATOL = 1e-4, 2e-5


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _topo(P):
    return SparseTopology(_t(P.idx), _t(P.w))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _arrays(state) -> dict:
    """{key: numpy} of either engine's state, keyed as the files are."""
    return {k: np.asarray(v) for k, v in jckpt._flatten(state).items()} \
        if _is_jax(state) else tckpt.flatten(state)


def _is_jax(state) -> bool:
    return any(isinstance(x, jax.Array) for x in jax.tree.leaves(state))


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close(a: dict, b: dict):
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        np.testing.assert_allclose(a[k].astype(np.float64),
                                   b[k].astype(np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# both engines on the reference's draws
# ---------------------------------------------------------------------------
def _pair(codec=None, seed=0):
    key = jax.random.PRNGKey(seed)
    data = jmake_dataset(key, M, n_train=16, n_test=8)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(jax.random.fold_in(key, 1), M))
    jmask = jpartition.build_mask(jcnn.init_params(key, CFG_J),
                                  jpartition.classifier_personal)
    tstacked = convert.params_from_reference(jax.tree.map(np.asarray,
                                                          stacked))
    tmask = tpartition.build_mask(tstacked, tpartition.classifier_personal)
    jopt = JSGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    topt = TSGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    kw = dict(k_v=1, k_u=2, lr_decay=0.99)
    if codec is not None:
        kw["codec_gamma"] = 0.5
    ja = jdfedpgp.DFedPGP(
        loss_fn=lambda p, b: jcnn.loss_fn(p, b, CFG_J), mask=jmask,
        opt_u=jopt, opt_v=jopt,
        codec=None if codec is None else jcompress.make_codec(
            codec, ratio=0.25), **kw)
    ta = tdfedpgp.DFedPGP(
        loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T), mask=tmask,
        opt_u=topt, opt_v=topt,
        codec=None if codec is None else tcompress.make_codec(
            codec, ratio=0.25), **kw)
    return data, stacked, tstacked, ja, ta


def _round_draws(data, r):
    b = jsample_batches(jax.random.fold_in(jax.random.PRNGKey(5), r), data,
                        3, 8)
    split = {"v": {k: a[:, :1] for k, a in b.items()},
             "u": {k: a[:, 1:] for k, a in b.items()}}
    P = jtopology.directed_random(jax.random.PRNGKey(40 + r), M, 3)
    tsplit = {p: {"x": _t(bb["x"]), "y": _t(bb["y"], torch.int64)}
              for p, bb in split.items()}
    return split, P, tsplit


def _reference_flat_run(ja, stacked, data, rounds):
    js, jl = ja.init_flat(stacked)
    step = jax.jit(lambda s, P, b: ja.round_fn_flat(s, P, b, jl))
    for r in range(rounds):
        b, P, _ = _round_draws(data, r)
        js, _ = step(js, P, b)
    return js, step


@pytest.mark.parametrize("codec", [None, "topk"])
def test_reference_flat_checkpoint_resumes_in_port(tmp_path, codec):
    """A reference-written FlatDFedPGPState (2 rounds; ef / ref with the
    codec) loads into a zeroed port template bit for bit, with the
    reference's key set, and the next round of each engine agrees."""
    data, stacked, tstacked, ja, ta = _pair(codec)
    js, jstep = _reference_flat_run(ja, stacked, data, 2)
    path = str(tmp_path / "flat")
    jckpt.save_pytree(path, js, metadata={"round": 2})
    tstate, tlayout = ta.init_flat(tstacked, device="cpu")
    assert (tstate.ef is None) == (codec is None)
    keys = set(np.load(path + ".npz").files)
    assert keys == set(tckpt.flatten(tstate))
    restored = tckpt.load_pytree(path, tckpt.zeros_like(tstate))
    assert restored.flat.dtype == torch.float32
    assert restored.round.dtype == torch.int32 and int(restored.round) == 2
    _equal(_arrays(restored), _arrays(js))

    b, P, tb = _round_draws(data, 2)
    js2, _ = jstep(js, P, b)
    ts2, _ = ta.round_fn_flat(restored, _topo(P), tb, tlayout)
    _close(_arrays(ts2), _arrays(js2))


@pytest.mark.parametrize("codec", [None, "topk"])
def test_port_flat_checkpoint_loads_in_reference(tmp_path, codec):
    """A port-written FlatDFedPGPState loads in the reference's
    load_pytree with equal arrays; resuming in the port is bitwise the
    uninterrupted port run."""
    data, stacked, tstacked, ja, ta = _pair(codec)
    ts, tl = ta.init_flat(tstacked, device="cpu")
    for r in range(2):
        _, P, tb = _round_draws(data, r)
        ts, _ = ta.round_fn_flat(ts, _topo(P), tb, tl)
    path = str(tmp_path / "port_flat")
    tckpt.save_pytree(path, ts)
    js0, _ = ja.init_flat(stacked)
    back = jckpt.load_pytree(path, jax.tree.map(jnp.zeros_like, js0))
    _equal(_arrays(back), _arrays(ts))
    resumed = tckpt.load_pytree(path, tckpt.zeros_like(ts))
    for r in range(2, 4):
        _, P, tb = _round_draws(data, r)
        ts, _ = ta.round_fn_flat(ts, _topo(P), tb, tl)
        resumed, _ = ta.round_fn_flat(resumed, _topo(P), tb, tl)
    _equal(_arrays(resumed), _arrays(ts))


def _tick_draws(data, t):
    b = jsample_batches(jax.random.fold_in(jax.random.PRNGKey(7), t), data,
                        1, 8)
    b = jax.tree.map(lambda a: a[:, 0], b)
    P = jtopology.to_push_sparse(jtopology.directed_random(
        jax.random.PRNGKey(100 + t), M, 3))
    return b, P, {"x": _t(b["x"]), "y": _t(b["y"], torch.int64)}


@pytest.mark.parametrize("codec", [None, "topk"])
def test_async_checkpoint_moves_both_ways(tmp_path, codec):
    """The reference's AsyncState + ClientProfile after 7 ticks (tiered
    speeds, delays up to 2, duty 0.7) loads into the port bit for bit —
    the clock's tick back as an int — and 3 more ticks of each engine
    agree; the port's file of the same blob loads in the reference."""
    data, stacked, tstacked, ja, ta = _pair(codec)
    jprof = jprofiles.tiered(M, spread=3.0, push_delay_max=2,
                             availability=0.7, seed=1)
    jrt, js = JAsyncRuntime.build(ja, stacked, jprof, depth=3)
    jtick = jax.jit(lambda s, p, b: jrt.tick(s, p, b))
    for t in range(7):
        b, P, _ = _tick_draws(data, t)
        js, _ = jtick(js, P, b)
    path = str(tmp_path / "async")
    jckpt.save_pytree(path, {"state": js, "profile": jprof},
                      metadata={"tick": 7})

    tprof = tprofiles.tiered(M, spread=3.0, push_delay_max=2,
                             availability=0.7, seed=1)
    trt, ts0 = AsyncRuntime.build(ta, tstacked, tprof, depth=3,
                                  device="cpu")
    template = tckpt.zeros_like({"state": ts0, "profile": tprof})
    assert set(np.load(path + ".npz").files) == set(tckpt.flatten(template))
    blob = tckpt.load_pytree(path, template)
    ts, prof = blob["state"], blob["profile"]
    assert isinstance(ts.clock.t, int) and ts.clock.t == 7
    assert isinstance(prof.step_cost, np.ndarray)
    _equal(_arrays(ts), _arrays(js))
    _equal(tckpt.flatten(prof), _arrays(jprof))
    trt = dataclasses.replace(trt, profile=prof.to("cpu"))
    for t in range(7, 10):
        b, P, tb = _tick_draws(data, t)
        js, _ = jtick(js, P, b)
        ts, _ = trt.tick(ts, _topo(P), tb)
    _close(_arrays(ts), _arrays(js))
    assert ts.clock.t == int(js.clock.t) == 10

    back_path = str(tmp_path / "port_async")
    tckpt.save_pytree(back_path, {"state": ts, "profile": prof})
    back = jckpt.load_pytree(back_path, jax.tree.map(
        jnp.zeros_like, {"state": js, "profile": jprof}))
    assert back["state"].clock.t.dtype == jnp.int32
    _equal(_arrays(back["state"]), _arrays(ts))


def test_async_checkpoint_resumes_port_run_bitwise(tmp_path):
    """7 ticks, save with the profile, restore into a zeroed template,
    5 more ticks: bitwise the uninterrupted port run (mailbox ring, clock
    and codec memory included)."""
    data, stacked, tstacked, ja, ta = _pair("topk")
    tprof = tprofiles.tiered(M, spread=4.0, push_delay_max=2,
                             availability=0.7, seed=3)
    trt, ts = AsyncRuntime.build(ta, tstacked, tprof, depth=3,
                                 device="cpu")
    draws = [_tick_draws(data, t) for t in range(12)]
    for t in range(7):
        ts, _ = trt.tick(ts, _topo(draws[t][1]), draws[t][2])
    path = str(tmp_path / "async_port")
    tckpt.save_pytree(path, {"state": ts, "profile": tprof})
    blob = tckpt.load_pytree(path, tckpt.zeros_like(
        {"state": ts, "profile": tprof}))
    restored = blob["state"]
    _equal(_arrays(restored), _arrays(ts))
    _equal(tckpt.flatten(blob["profile"]), tckpt.flatten(tprof))
    trt2 = dataclasses.replace(trt, profile=blob["profile"].to("cpu"))
    for t in range(7, 12):
        ts, _ = trt.tick(ts, _topo(draws[t][1]), draws[t][2])
        restored, _ = trt2.tick(restored, _topo(draws[t][1]), draws[t][2])
    _equal(_arrays(restored), _arrays(ts))
    assert restored.clock.t == 12


# ---------------------------------------------------------------------------
# bf16 bits, legacy files, train-state rotation
# ---------------------------------------------------------------------------
def _bf16_bits(seed=0, n=64):
    bits = np.random.default_rng(seed).integers(0, 2 ** 16, n,
                                                dtype=np.uint16)
    return bits


def test_bf16_bits_exact_both_ways(tmp_path):
    bits = _bf16_bits()
    t_leaf = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16)
    ttree = {"w": t_leaf, "b": torch.ones(3)}
    path = str(tmp_path / "bf16_port")
    tckpt.save_pytree(path, ttree)
    raw = np.load(path + ".npz")
    assert raw["w"].dtype == np.uint16
    np.testing.assert_array_equal(raw["w"], bits)
    back = tckpt.load_pytree(path, tckpt.zeros_like(ttree))
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    jback = jckpt.load_pytree(path, {"w": jnp.zeros((64,), jnp.bfloat16),
                                     "b": jnp.zeros((3,))})
    np.testing.assert_array_equal(np.asarray(jback["w"]).view(np.uint16),
                                  bits)
    # the reference's file into the port
    jpath = str(tmp_path / "bf16_ref")
    jckpt.save_pytree(jpath, {"w": jnp.asarray(bits.view(jnp.bfloat16)),
                              "b": jnp.ones((3,))})
    tb = tckpt.load_pytree(jpath, tckpt.zeros_like(ttree))
    np.testing.assert_array_equal(tb["w"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)


def test_legacy_void_bf16_file_loads(tmp_path):
    """Files written before the uint16 convention stored bf16 as 2-byte
    void; both readers view them back as bf16."""
    bits = _bf16_bits(1, 16)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, w=bits.view(np.dtype("V2")))
    tb = tckpt.load_pytree(path, {"w": torch.zeros(16,
                                                   dtype=torch.bfloat16)})
    np.testing.assert_array_equal(tb["w"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    jb = jckpt.load_pytree(path, {"w": jnp.zeros((16,), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(jb["w"]).view(np.uint16),
                                  bits)


def test_load_rejects_shape_mismatch(tmp_path):
    path = str(tmp_path / "shape")
    tckpt.save_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="a:"):
        tckpt.load_pytree(path, {"a": torch.zeros(4)})


def test_save_train_state_keeps_three_like_reference(tmp_path):
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    os.makedirs(tdir)
    os.makedirs(jdir)
    assert tckpt.restore_train_state(str(tdir), {"a": torch.zeros(2)}) \
        == (None, 0)
    for step in (1, 5, 9, 12, 20):
        tckpt.save_train_state(str(tdir), step,
                               {"a": torch.full((2,), float(step))})
        jckpt.save_train_state(str(jdir), step,
                               {"a": jnp.full((2,), float(step))})
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(f for f in os.listdir(tdir) if f.endswith(".npz")) == [
        "step_00000009.npz", "step_00000012.npz", "step_00000020.npz"]
    state, step = tckpt.restore_train_state(str(tdir),
                                            {"a": torch.zeros(2)})
    assert step == 20 and state["a"].tolist() == [20.0, 20.0]
    # each package restores the other's latest
    jstate, jstep = jckpt.restore_train_state(str(tdir),
                                              {"a": jnp.zeros((2,))})
    assert jstep == 20 and np.asarray(jstate["a"]).tolist() == [20.0, 20.0]


# ---------------------------------------------------------------------------
# serve.from_checkpoint
# ---------------------------------------------------------------------------
def _serving_equal(a, b):
    for part in ("trunk", "personal"):
        ta, tb = getattr(a, part), getattr(b, part)
        for path, leaf in tree.paths(ta):
            assert torch.equal(leaf, tree.get(tb, path)), (part, path)


def test_from_checkpoint_roundtrips_both_forms(tmp_path):
    data, stacked, tstacked, ja, ta = _pair()
    ts, tl = ta.init_flat(tstacked, device="cpu")
    for r in range(2):
        _, P, tb = _round_draws(data, r)
        ts, _ = ta.round_fn_flat(ts, _topo(P), tb, tl)
    ckdir = str(tmp_path / "ck")
    tckpt.save_train_state(ckdir, 2, ts)
    for consensus in ("mass", "mean", 3):
        want = tserve_state.from_train_state(ts, layout=tl,
                                             consensus=consensus)
        got, step = tserve_state.from_checkpoint(
            ckdir, tckpt.zeros_like(ts), layout=tl, consensus=consensus)
        assert step == 2
        _serving_equal(got, want)
    # the tree form, with its mask
    tree_state = ta.state_from_flat(ts, tl)
    tdir = str(tmp_path / "tree")
    tckpt.save_train_state(tdir, 4, tree_state)
    got, step = tserve_state.from_checkpoint(
        tdir, tckpt.zeros_like(tree_state), mask=ta.mask)
    assert step == 4
    _serving_equal(got, tserve_state.from_train_state(ts, layout=tl))
    with pytest.raises(FileNotFoundError):
        tserve_state.from_checkpoint(str(tmp_path), ts, layout=tl)


def test_from_checkpoint_reads_reference_file(tmp_path):
    """The reference's checkpoint directory served by both packages: the
    anchored trunk (an elementwise de-bias) and the heads are equal."""
    data, stacked, tstacked, ja, ta = _pair()
    js, _ = _reference_flat_run(ja, stacked, data, 2)
    ckdir = str(tmp_path / "ref_ck")
    jckpt.save_train_state(ckdir, 2, js)
    _, jl = ja.init_flat(stacked)
    jserv, jstep = jserve_state.from_checkpoint(
        ckdir, jax.tree.map(jnp.zeros_like, js), layout=jl, consensus=1)
    ts0, tl = ta.init_flat(tstacked, device="cpu")
    tserv, tstep = tserve_state.from_checkpoint(
        ckdir, tckpt.zeros_like(ts0), layout=tl, consensus=1)
    assert jstep == tstep == 2
    for path, leaf in tree.paths(tserv.trunk):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(
            tree.get(jserv.trunk, path)), err_msg=str(path))
    for path, leaf in tree.paths(tserv.personal):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(
            tree.get(jserv.personal, path)), err_msg=str(path))


# ---------------------------------------------------------------------------
# the optimizer's helpers (tests/test_optim_ckpt.py on the port)
# ---------------------------------------------------------------------------
def test_port_sgd_matches_manual_and_reference():
    opt = TSGD(lr=0.1, momentum=0.9, weight_decay=0.01)
    p = {"w": torch.tensor([1.0, -2.0])}
    s = opt.init(p)
    assert torch.equal(s.momentum["w"], torch.zeros(2))
    g = {"w": torch.tensor([0.5, 0.5])}
    p1, s1 = opt.update(g, s, p)
    gd = np.array([0.5, 0.5]) + 0.01 * np.array([1.0, -2.0])
    m1 = 0.9 * 0.0 + gd
    np.testing.assert_allclose(p1["w"].numpy(),
                               np.array([1.0, -2.0]) - 0.1 * m1, rtol=1e-6)
    p2, s2 = opt.update(g, s1, p1)
    gd2 = np.array([0.5, 0.5]) + 0.01 * p1["w"].numpy()
    m2 = 0.9 * m1 + gd2
    np.testing.assert_allclose(p2["w"].numpy(), p1["w"].numpy() - 0.1 * m2,
                               rtol=1e-6)
    jopt = JSGD(lr=0.1, momentum=0.9, weight_decay=0.01)
    jp = {"w": jnp.array([1.0, -2.0])}
    js = jopt.init(jp)
    for _ in range(2):
        jp, js = jopt.update({"w": jnp.array([0.5, 0.5])}, js, jp)
    np.testing.assert_array_equal(p2["w"].numpy(), np.asarray(jp["w"]))
    np.testing.assert_array_equal(s2.momentum["w"].numpy(),
                                  np.asarray(js.momentum["w"]))


def test_port_sgd_scalar_placeholder_grads_freeze_param():
    opt = TSGD(lr=0.1, momentum=0.9, weight_decay=0.1)
    p = {"w": torch.tensor([3.0, 4.0])}
    s = TSGDState({"w": torch.zeros(())})
    p1, s1 = opt.update({"w": torch.zeros(())}, s, p)
    np.testing.assert_allclose(p1["w"].numpy(), [3.0, 4.0], atol=1e-7)
    assert s1.momentum["w"].shape == ()


def test_port_exp_decay_schedule():
    from repro.optim import exp_decay_schedule as jsched
    sched, ref = exp_decay_schedule(0.1, 0.99), jsched(0.1, 0.99)
    assert abs(sched(0) - 0.1) < 1e-9
    assert abs(sched(10) - 0.1 * 0.99 ** 10) < 1e-9
    assert all(sched(t) == ref(t) for t in range(50))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_port_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 10,
         "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    tg, tn = clip_by_global_norm(tree.tree_map(torch.from_numpy, g),
                                 max_norm)
    jg, jn = jclip(jax.tree.map(jnp.asarray, g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for path, leaf in tree.paths(tg):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(
            tree.get(jg, path)), rtol=1e-6, atol=1e-7)
    full = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    np.testing.assert_allclose(float(full[1]), 20.0, rtol=1e-5)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(
        full[0]["a"])), 1.0, rtol=1e-5)
    # a bare tensor is a one-leaf tree
    bare, n = clip_by_global_norm(torch.full((4,), 10.0), 1.0)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(bare)), 1.0,
                               rtol=1e-5)


def test_port_checkpoint_roundtrip_nested_tree(tmp_path):
    """Lists, a bf16 leaf and a 0-d leaf; the keys are the reference's."""
    ttree = {"layers": [{"w": torch.arange(6.0).reshape(2, 3)},
                        {"w": torch.ones(4, dtype=torch.bfloat16)}],
             "mu": torch.tensor(2.5)}
    path = os.path.join(tmp_path, "ckpt")
    tckpt.save_pytree(path, ttree, metadata={"round": 7})
    assert open(path + ".meta.json").read().count("7") == 1
    back = tckpt.load_pytree(path, tckpt.zeros_like(ttree))
    for a, b in zip(tckpt.flatten(ttree).values(),
                    tckpt.flatten(back).values()):
        np.testing.assert_array_equal(a, b)
    assert back["layers"][1]["w"].dtype == torch.bfloat16
    jtree = {"layers": [{"w": jnp.arange(6.0).reshape(2, 3)},
                        {"w": jnp.ones((4,), jnp.bfloat16)}],
             "mu": jnp.array(2.5)}
    assert set(tckpt.flatten(ttree)) == set(jckpt._flatten(jtree)) == {
        "layers/0/w", "layers/1/w", "mu"}
