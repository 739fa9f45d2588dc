"""Port parity of the paper's server-side baselines (LocalOnly, FedAvg,
FedPer, FedRep, FedBABU with its fine-tune, Ditto): the same data, initial
parameters, minibatches and CFL client samples (drawn by the JAX reference)
go through both `run_experiment`s, and the final personalized models,
losses and accuracies are compared."""
import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import partition as jpartition
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.fl import simulator as jsim
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import baselines as tbaselines
from repro_torch.core import partition as tpartition
from repro_torch.fl import simulator as tsim
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGDState

torch.set_num_threads(2)
M = 8
# sample_ratio 0.25: 2 of the 8 clients per CFL round
SIM_KW = dict(m=M, rounds=3, n_neighbors=3, n_train=16, n_test=8, batch=8,
              k_local=2, k_personal=1, sample_ratio=0.25)
CFG_J = jcnn.CNNConfig()
CFG_T = tcnn.CNNConfig()
# Both engines compute in f32, but XLA:CPU and oneDNN sum convolutions,
# GroupNorm and matmuls in other orders, and the server mean is an einsum
# against a tensordot; 9 SGD steps (3 rounds of 3; Ditto 18) carry that
# ~1e-7 relative noise forward.  Measured max abs difference of the final
# personalized models at this size: 3.3e-6 (local, every client steps every
# round), 3.9e-7 (fedavg), 6.6e-7 (fedper), 5.0e-7 (fedrep), 2.4e-7
# (fedbabu), 2.5e-7 (ditto); 1.2e-7 after the fine-tune; 1.1e-6 after one
# Ditto round from the reference's state.  Tolerance rtol 1e-4, atol 2e-5,
# as tests/test_torch_dfedpgp.py.
RTOL, ATOL = 1e-4, 2e-5
SERVER_ALGOS = ("local", "fedavg", "fedper", "fedrep", "fedbabu", "ditto")


def _reference_draws(sim):
    """The reference run's key layout (repro/fl/simulator.py:289-303,
    :427-432): data, stacked init, per-round batches and CFL samples."""
    key = jax.random.PRNGKey(sim.seed)
    k_data, k_init, k_run = jax.random.split(key, 3)
    data = jmake_dataset(k_data, sim.m, n_classes=sim.n_classes,
                         dist=sim.dist, alpha=sim.alpha, c=sim.c,
                         n_train=sim.n_train, n_test=sim.n_test,
                         size=sim.image_size, noise=sim.noise)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(k_init, sim.m))
    k_total = sim.k_local + sim.k_personal

    def keys(r):
        return jax.random.split(jax.random.fold_in(k_run, r), 3)

    def batches_at(r):
        return jax.tree.map(np.asarray, jsample_batches(
            keys(r)[1], data, k_total, sim.batch))

    def sampled_at(r):
        return np.asarray(jbaselines._sample(keys(r)[2], sim.m,
                                             sim.sample_ratio))

    return data, stacked, batches_at, sampled_at


def _close(t, j, what, errs=None):
    t = t.detach().numpy()
    np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=ATOL,
                               err_msg=what)
    if errs is not None:
        errs.append(float(np.max(np.abs(t - np.asarray(j)))))


def _close_tree(t_tree, j_tree, what, errs=None):
    for path, leaf in tree.paths(t_tree):
        _close(leaf, tree.get(j_tree, path), what + "/" + "/".join(path),
               errs)


@pytest.fixture(scope="module")
def draws():
    sim = jsim.SimConfig(**SIM_KW)
    data, stacked, batches_at, sampled_at = _reference_draws(sim)
    return dict(data=tuple(np.asarray(a) for a in data),
                stacked=jax.tree.map(np.asarray, stacked),
                batches_at=batches_at, sampled_at=sampled_at)


def _port_run(algo, draws, **kw):
    return tsim.run_experiment(
        algo, tsim.SimConfig(**SIM_KW), device="cpu", eval_every=1,
        return_state=True, data=draws["data"],
        init_params=draws["stacked"], batches_at=draws["batches_at"],
        sampled_at=draws["sampled_at"], **kw)


@pytest.mark.parametrize("algo", SERVER_ALGOS)
def test_server_baseline_three_rounds_match_reference(draws, algo):
    # acc counts argmax hits over m * n_test = 64 images: the parameter
    # noise above may flip a near-tie, so one image per eval (1/64)
    jh = jsim.run_experiment(algo, jsim.SimConfig(**SIM_KW), eval_every=1,
                             return_params=True)
    th = _port_run(algo, draws)
    assert th["round"] == jh["round"] == [1, 2, 3]
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 64 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    # CFL and local runs put nothing on a wire
    assert th["wire_bytes"] == jh["wire_bytes"] == [0, 0, 0]
    tp = tsim.build_algorithm(algo, None, None, tsim.SimConfig(**SIM_KW)
                              ).eval_params(th["state"])
    _close_tree(tp, jax.tree.map(np.asarray, jh["params"]), algo)
    assert int(th["state"].round) == 3


def test_cfl_rounds_keep_unsampled_clients_and_average_the_sampled(draws):
    # one FedAvg round from the reference's init: the unsampled clients'
    # params and momenta stay bit for bit, the new global model is the
    # mean of the sampled clients' trained models
    algo = tbaselines.FedAvg(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                             sample_ratio=0.25)
    state = algo.init(convert.params_from_reference(draws["stacked"]),
                      device="cpu")
    b = {k: torch.as_tensor(v) for k, v in draws["batches_at"](0).items()}
    sampled = torch.as_tensor(draws["sampled_at"](0))
    assert float(sampled.sum()) == 2.0
    new, metrics = algo.round_fn(state, sampled, b)
    keep = sampled == 0
    for path, leaf in tree.paths(new.params):
        old = tree.get(state.params, path)
        assert torch.equal(leaf[keep], old[keep])
        assert not torch.equal(leaf[~keep], old[~keep])
        torch.testing.assert_close(tree.get(new.extra, path),
                                   leaf[~keep].mean(0), rtol=1e-6,
                                   atol=1e-7)
    for leaf in tree.leaves(new.opt.momentum):
        assert not leaf[keep].any()
    assert torch.isfinite(metrics["loss"])


def test_port_sample_draws_ratio_m_clients_from_its_generator():
    g = torch.Generator().manual_seed(3)
    s = tbaselines.sample(g, 100, 0.1)
    assert s.dtype == torch.float32 and float(s.sum()) == 10.0
    assert set(s.unique().tolist()) == {0.0, 1.0}
    again = tbaselines.sample(torch.Generator().manual_seed(3), 100, 0.1)
    assert torch.equal(s, again)
    assert float(tbaselines.sample(g, 4, 0.1).sum()) == 1.0   # at least 1
    # run_experiment draws each round's sample from its own CPU stream
    sim = tsim.SimConfig(m=6, rounds=2, n_train=8, n_test=4, batch=4,
                         k_local=1, k_personal=1, sample_ratio=0.5)
    h1 = tsim.run_experiment("fedavg", sim, device="cpu", eval_every=1)
    h2 = tsim.run_experiment("fedavg", sim, device="cpu", eval_every=1)
    assert h1["loss"] == h2["loss"] and np.all(np.isfinite(h1["loss"]))


def test_fedbabu_finetune_and_state_conversion_match_reference(draws):
    # FedBABU trains only the body; its eval-time fine-tune steps the whole
    # model.  Both engines fine-tune the REFERENCE's 3-round state, carried
    # across by convert.baseline_state_from_reference
    sim = jsim.SimConfig(**SIM_KW)
    data, stacked, batches_at, _ = _reference_draws(sim)

    def jloss(p, batch):
        return jcnn.loss_fn(p, batch, CFG_J)

    mask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                  CFG_J),
                                 jpartition.classifier_personal)
    jalgo = jsim.build_algorithm("fedbabu", jloss, mask, sim)
    jstate = jalgo.init(stacked)
    jround = jax.jit(jalgo.round_fn)
    for r in range(2):
        jstate, _ = jround(jstate, jax.random.PRNGKey(r),
                           jax.tree.map(jax.numpy.asarray, batches_at(r)))
    b = batches_at(2)
    jtuned = jalgo.finetune(jstate, jax.tree.map(jax.numpy.asarray, b),
                            steps=2)

    tstate = convert.baseline_state_from_reference(
        jax.tree.map(np.asarray, jstate))
    assert isinstance(tstate, tbaselines.SimpleState)
    _close_tree(tstate.params, jax.tree.map(np.asarray, jstate.params),
                "converted")
    # the global shared part: classifier leaves dropped
    assert "classifier" not in tstate.extra and "features" in tstate.extra
    tmask = tpartition.build_mask(tstate.params,
                                  tpartition.classifier_personal)
    talgo = tsim.build_algorithm("fedbabu",
                                 lambda p, bb: tcnn.loss_fn(p, bb, CFG_T),
                                 tmask, tsim.SimConfig(**SIM_KW))
    ttuned = talgo.finetune(tstate, {k: torch.as_tensor(v)
                                     for k, v in b.items()}, steps=2)
    _close_tree(ttuned, jax.tree.map(np.asarray, jtuned), "finetune")
    # the fine-tune moves the personal head the body rounds left frozen
    assert not torch.equal(ttuned["classifier"]["w"],
                           tstate.params["classifier"]["w"])
    assert torch.equal(tstate.params["classifier"]["w"],
                       torch.as_tensor(np.asarray(
                           stacked["classifier"]["w"])))


def test_ditto_state_conversion_and_one_round_match_reference(draws):
    # one Ditto round from the reference's 2-round state on both engines
    sim = jsim.SimConfig(**SIM_KW)
    data, stacked, batches_at, sampled_at = _reference_draws(sim)

    def jloss(p, batch):
        return jcnn.loss_fn(p, batch, CFG_J)

    jalgo = jsim.build_algorithm("ditto", jloss, None, sim)
    jstate = jalgo.init(stacked)
    for r in range(2):
        jstate, _ = jalgo.round_fn(jstate, jax.random.PRNGKey(r),
                                   jax.tree.map(jax.numpy.asarray,
                                                batches_at(r)))
    key = jax.random.PRNGKey(11)
    jnew, jm = jalgo.round_fn(jstate, key, jax.tree.map(jax.numpy.asarray,
                                                        batches_at(2)))
    tstate = convert.baseline_state_from_reference(
        jax.tree.map(np.asarray, jstate))
    assert isinstance(tstate, tbaselines.DittoState)
    talgo = tsim.build_algorithm("ditto",
                                 lambda p, bb: tcnn.loss_fn(p, bb, CFG_T),
                                 None, tsim.SimConfig(**SIM_KW))
    sampled = torch.as_tensor(np.asarray(jbaselines._sample(
        key, sim.m, sim.sample_ratio)))
    tnew, tm = talgo.round_fn(tstate, sampled, {
        k: torch.as_tensor(v) for k, v in batches_at(2).items()})
    jn = jax.tree.map(np.asarray, jnew)
    for name in ("personal", "glob_stacked", "glob"):
        _close_tree(getattr(tnew, name), getattr(jn, name), name)
    _close_tree(tnew.opt_p.momentum, jn.opt_p.momentum, "opt_p")
    _close_tree(tnew.opt_g.momentum, jn.opt_g.momentum, "opt_g")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    with pytest.raises(TypeError, match="not a baseline state"):
        convert.baseline_state_from_reference(SGDState(None))


def test_xent_keeps_f64_logits_in_f64():
    # f32 and bf16 logits are taken in f32 as before; f64 logits stay f64
    # (the baselines' f64 card-vs-CPU rounds of chip_smoke.py)
    from repro_torch.models import layers
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(rng.standard_normal((6, 10)))
    y = torch.as_tensor(rng.integers(0, 10, 6))
    l64 = layers.softmax_xent(logits, y)
    l32 = layers.softmax_xent(logits.float(), y)
    assert l64.dtype == torch.float64 and l32.dtype == torch.float32
    assert layers.softmax_xent(logits.bfloat16(), y).dtype == torch.float32
    want = torch.nn.functional.cross_entropy(logits, y)
    assert abs(float(l64) - float(want)) < 1e-12
    np.testing.assert_allclose(float(l32), float(want), rtol=1e-6)
