"""Port parity of the dense kernel mix and the tree-form round: the
pushsum_mix plain version against the reference's Pallas kernel in
interpret mode, `make_kernel_mix_flat` / `make_kernel_mix` rounds, the
tree-form `round_fn` / `eval_params`, the tree <-> resident state
conversions and `run_experiment(resident=False)` — each against the JAX
reference on the same numpy inputs.

The CUDA pushsum_mix kernel itself runs only on a GPU; `chip_smoke.py`
holds it against `pushsum_mix_ref` there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_mix as jkernel_mix
from repro.core import partition as jpartition
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.fl import simulator as jsim
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import kernel_mix as tkernel_mix
from repro_torch.core import partition as tpartition
from repro_torch.core import topology as ttopology
from repro_torch.fl import simulator as tsim
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGD as TSGD

torch.set_num_threads(2)
M = 8
SIM_KW = dict(m=M, rounds=3, n_neighbors=3, n_train=16, n_test=8, batch=8,
              k_local=2, k_personal=1)
CFG_J = jcnn.CNNConfig()
CFG_T = tcnn.CNNConfig()
# conv / GroupNorm / matmul summation order differs between XLA:CPU and
# oneDNN, carried through 9 SGD steps (3 rounds of 1 + 2): the bound of
# the resident round's parity test, rtol 1e-4, atol 2e-5.  The dense
# (m, m) mix sums 8 products in BLAS order on each side: well inside it.
RTOL, ATOL = 1e-4, 2e-5


# ---------------------------------------------------------------------------
# pushsum_mix plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,d", [(1, 1), (7, 511), (8, 513), (13, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pushsum_mix_plain_equals_reference_kernel(m, d, dtype):
    # f32: both sides take an f32 product, summed in other orders: rtol/
    # atol 1e-5.  bf16 U: both round the f32 result once, and an ulp-level
    # f32 difference can flip that rounding: one bf16 ulp, rtol/atol 8e-3
    rng = np.random.default_rng(m * 1000 + d)
    P = rng.random((m, m)).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    U = rng.standard_normal((m, d)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = tref.pushsum_mix_ref(torch.as_tensor(P), torch.as_tensor(U).to(tdt))
    assert got.dtype == tdt and got.shape == (m, d)
    assert torch.equal(got, tops.pushsum_mix(torch.as_tensor(P),
                                             torch.as_tensor(U).to(tdt)))
    want = jops.pushsum_mix(jnp.asarray(P), jnp.asarray(U).astype(jdt),
                            force="pallas")
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------
def _reference_draws(sim):
    """The reference run's key layout (repro/fl/simulator.py:289-303,
    :427-432): data, stacked init, and per-round batches and tables."""
    key = jax.random.PRNGKey(sim.seed)
    k_data, k_init, k_run = jax.random.split(key, 3)
    data = jmake_dataset(k_data, sim.m, n_classes=sim.n_classes,
                         dist=sim.dist, alpha=sim.alpha, c=sim.c,
                         n_train=sim.n_train, n_test=sim.n_test,
                         size=sim.image_size, noise=sim.noise)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(k_init, sim.m))
    schedule = jtopology.get_schedule(sim.topology, sim.m, sim.n_neighbors,
                                      sim.seed)
    k_total = sim.k_local + sim.k_personal

    def batches_at(r):
        _, k_batch, _ = jax.random.split(jax.random.fold_in(k_run, r), 3)
        return jax.tree.map(np.asarray, jsample_batches(k_batch, data,
                                                        k_total, sim.batch))

    def topology_at(r):
        P = schedule.at(r)
        return np.asarray(P.idx), np.asarray(P.w)

    return data, stacked, batches_at, topology_at


def _split(batches, kv):
    return {"v": {k: a[:, :kv] for k, a in batches.items()},
            "u": {k: a[:, kv:] for k, a in batches.items()}}


def _close(t, j, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_tree(t_tree, j_tree, what):
    for path, leaf in tree.paths(t_tree):
        ref = j_tree
        for key in path:
            ref = ref[key]
        _close(leaf, ref, what + "/" + "/".join(path))


def _algos(sim, stacked, j_extra=None, t_extra=None):
    """The reference's and the port's DFedPGP from one config; j_extra /
    t_extra: mask -> extra DFedPGP fields (the mix overrides)."""
    jmask = jpartition.build_mask(
        jcnn.init_params(jax.random.PRNGKey(0), CFG_J),
        jpartition.classifier_personal)
    jalgo = dataclasses.replace(jsim.build_algorithm(
        "dfedpgp", lambda p, b: jcnn.loss_fn(p, b, CFG_J), jmask, sim),
        **(j_extra(jmask) if j_extra else {}))
    tstacked = convert.params_from_reference(jax.tree.map(np.asarray,
                                                          stacked))
    tmask = tpartition.build_mask(tstacked, tpartition.classifier_personal)
    opt = TSGD(lr=sim.lr, momentum=sim.momentum,
               weight_decay=sim.weight_decay)
    talgo = tdfedpgp.DFedPGP(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                             mask=tmask, opt_u=opt, opt_v=opt,
                             k_v=sim.k_personal, k_u=sim.k_local,
                             lr_decay=sim.lr_decay,
                             **(t_extra(tmask) if t_extra else {}))
    return jalgo, talgo, tstacked


def _rounds(form, j_extra=None, t_extra=None, rounds=3):
    """`rounds` rounds of each engine from the reference's init, tables and
    batches, in the resident ("flat") or the tree ("tree") form."""
    sim = jsim.SimConfig(**SIM_KW)
    _, stacked, batches_at, topology_at = _reference_draws(sim)
    jalgo, talgo, tstacked = _algos(sim, stacked, j_extra, t_extra)
    out = dict(jalgo=jalgo, talgo=talgo)
    if form == "flat":
        jstate, out["jlayout"] = jalgo.init_flat(stacked)
        tstate, out["tlayout"] = talgo.init_flat(tstacked, device="cpu")
        jround = jax.jit(lambda s, P, b: jalgo.round_fn_flat(
            s, P, b, out["jlayout"]))

        def tround(s, P, b):
            return talgo.round_fn_flat(s, P, b, out["tlayout"])
    else:
        jstate = jalgo.init(stacked)
        tstate = talgo.init(tstacked, device="cpu")
        jround, tround = jax.jit(jalgo.round_fn), talgo.round_fn
    kv = sim.k_personal
    for r in range(rounds):
        b = batches_at(r)
        idx, w = topology_at(r)
        jstate, out["jm"] = jround(
            jstate, jtopology.SparseTopology(jnp.asarray(idx),
                                             jnp.asarray(w)),
            _split(jax.tree.map(jnp.asarray, b), kv))
        tstate, out["tm"] = tround(
            tstate, ttopology.SparseTopology(torch.from_numpy(np.array(idx)),
                                             torch.from_numpy(np.array(w))),
            _split({k: torch.from_numpy(np.array(a)) for k, a in b.items()},
                   kv))
    out.update(jstate=jstate, tstate=tstate)
    return out


def _check_metrics(out):
    for key in ("loss_v", "loss_u", "mu_min", "mu_max"):
        np.testing.assert_allclose(float(out["tm"][key]),
                                   float(out["jm"][key]), rtol=RTOL,
                                   err_msg=key)


def _check_flat_states(ts, js):
    assert int(ts.round) == int(js.round)
    _close(ts.flat, js.flat, "flat")
    _close(ts.mu, js.mu, "mu")
    _close(ts.opt_u.momentum, js.opt_u.momentum, "opt_u")
    _close_tree(ts.personal, jax.tree.map(np.asarray, js.personal),
                "personal")
    _close_tree(ts.opt_v.momentum,
                jax.tree.map(np.asarray, js.opt_v.momentum), "opt_v")


def _check_tree_states(ts, js):
    assert int(ts.round) == int(js.round)
    _close_tree(ts.params, jax.tree.map(np.asarray, js.params), "params")
    _close(ts.mu, js.mu, "mu")
    _close_tree(ts.opt_u.momentum, jax.tree.map(np.asarray,
                                                js.opt_u.momentum), "opt_u")
    _close_tree(ts.opt_v.momentum, jax.tree.map(np.asarray,
                                                js.opt_v.momentum), "opt_v")
    # the same leaves on both sides, placeholders included
    assert len(tree.leaves(ts.opt_u.momentum)) == len(
        jax.tree.leaves(js.opt_u.momentum))


def test_kernel_mix_flat_rounds_match_reference():
    out = _rounds(
        "flat",
        lambda mask: {"mix_fn_flat": jkernel_mix.make_kernel_mix_flat()},
        lambda mask: {"mix_fn_flat": tkernel_mix.make_kernel_mix_flat()})
    _check_flat_states(out["tstate"], out["jstate"])
    _check_metrics(out)


def test_kernel_mix_tree_rounds_match_reference():
    out = _rounds(
        "tree",
        lambda mask: {"mix_fn": jkernel_mix.make_kernel_mix(mask)},
        lambda mask: {"mix_fn": tkernel_mix.make_kernel_mix(mask)})
    _check_tree_states(out["tstate"], out["jstate"])
    _check_metrics(out)


@pytest.fixture(scope="module")
def tree_pair():
    return _rounds("tree")


def test_tree_round_fn_three_rounds_match_reference(tree_pair):
    _check_tree_states(tree_pair["tstate"], tree_pair["jstate"])
    _check_metrics(tree_pair)


def test_tree_eval_params_matches_reference(tree_pair):
    tp = tree_pair["talgo"].eval_params(tree_pair["tstate"])
    jp = tree_pair["jalgo"].eval_params(tree_pair["jstate"])
    _close_tree(tp, jax.tree.map(np.asarray, jp), "eval")


def test_state_conversions_match_reference_and_round_trip(tree_pair):
    talgo, jalgo = tree_pair["talgo"], tree_pair["jalgo"]
    ts, js = tree_pair["tstate"], tree_pair["jstate"]
    tf, tlayout = talgo.state_to_flat(ts)
    jf, jlayout = jalgo.state_to_flat(js)
    assert tlayout.d_flat == jlayout.d_flat == 13328
    _check_flat_states(tf, jf)
    # resident -> tree -> resident and tree -> resident -> tree are exact
    back = talgo.state_from_flat(tf, tlayout)
    for path, leaf in tree.paths(ts.params):
        assert torch.equal(leaf, tree.get(back.params, path))
    for a, b in ((ts.opt_u, back.opt_u), (ts.opt_v, back.opt_v)):
        for path, leaf in tree.paths(a.momentum):
            assert torch.equal(leaf, tree.get(b.momentum, path))
    assert torch.equal(back.mu, ts.mu) and int(back.round) == 3
    again, _ = talgo.state_to_flat(back, tlayout)
    assert torch.equal(again.flat, tf.flat)
    assert torch.equal(again.opt_u.momentum, tf.opt_u.momentum)
    _check_tree_states(back, jalgo.state_from_flat(jf, jlayout))
    # the reference's resident state, carried across, converts the same
    carried = convert.flat_state_from_reference(
        flat=jf.flat, personal=jax.tree.map(np.asarray, jf.personal),
        mu=jf.mu, mom_u=np.asarray(jf.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, jf.opt_v.momentum), round=jf.round)
    _check_tree_states(talgo.state_from_flat(carried, tlayout),
                       jalgo.state_from_flat(jf, jlayout))
    # and so does its tree-form state
    tcarried = convert.tree_state_from_reference(
        params=jax.tree.map(np.asarray, js.params), mu=js.mu,
        mom_u=jax.tree.map(np.asarray, js.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, js.opt_v.momentum), round=js.round)
    _check_tree_states(tcarried, js)
    _check_flat_states(talgo.state_to_flat(tcarried)[0], jf)


def test_resident_round_refuses_tree_mix_fn():
    stacked = tcnn.init_params(torch.Generator().manual_seed(0), CFG_T, (2,))
    mask = tpartition.build_mask(stacked, tpartition.classifier_personal)
    algo = tdfedpgp.DFedPGP(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                            mask=mask,
                            mix_fn=tkernel_mix.make_kernel_mix(mask))
    state, layout = algo.init_flat(stacked, device="cpu")
    with pytest.raises(ValueError, match="mix_fn_flat"):
        algo.round_fn_flat(state, None, {}, layout)


def test_run_experiment_tree_form_tracks_reference():
    # acc counts argmax hits over 64 test images: one image (1/64) of
    # slack per eval; the mean loss to rtol 1e-4
    kw = dict(SIM_KW, resident=False)
    sim = jsim.SimConfig(**kw)
    jh = jsim.run_experiment("dfedpgp", sim, eval_every=1)
    data, stacked, batches_at, topology_at = _reference_draws(sim)
    th = tsim.run_experiment(
        "dfedpgp", tsim.SimConfig(**kw), device="cpu", eval_every=1,
        return_state=True, data=tuple(np.asarray(a) for a in data),
        init_params=jax.tree.map(np.asarray, stacked),
        topology_at=topology_at, batches_at=batches_at)
    assert th["round"] == jh["round"] == [1, 2, 3]
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 64 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert isinstance(th["state"], tdfedpgp.DFedPGPState)
    assert th["layout"] is None
