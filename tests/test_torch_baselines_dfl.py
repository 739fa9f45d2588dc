"""Port parity of the paper's gossip baselines (DFedAvgM, DFedAvgM-P, OSGP,
Dis-PFL), the undirected topology they run on, `gossip.mix_tree`'s one-
buffer route, the osgp / dfedavgm flat-core codec runs, and the refusals
of `run_experiment`.  The reference draws every input (data, init, tables,
batches, Dis-PFL masks); both engines run on them."""
import jax
import numpy as np
import pytest
import torch

from repro.core import partition as jpartition
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.fl import simulator as jsim
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import gossip as tgossip
from repro_torch.core import topology as ttopology
from repro_torch.fl import simulator as tsim
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn as tcnn

torch.set_num_threads(2)
# m 12, n 2: the undirected width k = min(3n, m-1) + 1 = 7 < m, so the
# baselines mix through the sparse route (at m 8, n 3, k = m densifies)
M = 12
SIM_KW = dict(m=M, rounds=3, n_neighbors=2, n_train=16, n_test=8, batch=8,
              k_local=2, k_personal=1)
CFG_J = jcnn.CNNConfig()
# f32 on both engines; XLA:CPU and oneDNN sum convolutions, GroupNorm and
# matmuls in other orders and XLA may contract the mix's multiply-add; 9
# SGD steps carry that noise forward.  Measured max abs difference of the
# final personalized models at this size: 2.4e-7 (dfedavgm), 6.0e-7
# (dfedavgm-p), 3.9e-7 (osgp), 2.4e-7 (dispfl); 2.5e-7 (osgp, topk codec),
# 6.9e-7 (dfedavgm, topk codec, 6 of 12 clients a round).  Tolerance rtol
# 1e-4, atol 2e-5, as tests/test_torch_dfedpgp.py.
RTOL, ATOL = 1e-4, 2e-5
DFL_ALGOS = ("dfedavgm", "dfedavgm-p", "osgp", "dispfl")


def _close_tree(t_tree, j_tree, what):
    for path, leaf in tree.paths(t_tree):
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(tree.get(j_tree, path)),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=what + "/" + "/".join(path))


# ---------------------------------------------------------------------------
# the undirected topology
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,k", [(12, 2, 7), (8, 3, 8), (100, 10, 31),
                                   (5, 9, 5)])
def test_undirected_tables_bitwise_from_reference_picks(m, n, k):
    # the construction after the draw is the reference's numpy code: from
    # the reference's own picks the tables are equal bit for bit, including
    # the argpartition order of each row (the mix's sum order)
    for t in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(5), t)
        want = jtopology.undirected_random(key, m, n)
        picks = np.asarray(jtopology.directed_random(key, m,
                                                     min(n, m - 1)).idx)
        got = ttopology.undirected_from_picks(picks, m, min(n, m - 1))
        assert got.idx.dtype == torch.int32 and got.w.dtype == torch.float32
        assert got.idx.shape == (m, k)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
        assert tgossip.no_sparsity(got) == (k >= m)


def test_undirected_schedule_is_symmetric_doubly_stochastic_and_pure():
    s = ttopology.get_schedule("undirected", 12, 2, seed=3)
    assert s == ttopology.TopologySchedule("undirected", 12, 2, 3)
    a, b = s.at(4), s.at(4)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.w, b.w)
    assert a.idx.shape == (12, 7) and not torch.equal(a.w, s.at(5).w)
    D = a.dense()
    assert torch.equal(D, D.T)
    np.testing.assert_allclose(D.sum(0).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(D.sum(1).numpy(), 1.0, rtol=1e-6)
    assert bool((torch.diagonal(D) > 0).all())
    with pytest.raises(ValueError, match="MAX_DENSE_M"):
        ttopology.get_schedule("undirected", ttopology.MAX_DENSE_M + 1, 2)
    with pytest.raises(ValueError, match="known"):
        ttopology.get_schedule("hypercube", 8)


# ---------------------------------------------------------------------------
# mix_tree: all f32 leaves in one flat buffer, one gossip_gather call
# ---------------------------------------------------------------------------
@pytest.fixture
def gather_calls(monkeypatch):
    calls = []

    def counted(idx, w, U, *a, **kw):
        calls.append(tuple(U.shape))
        return ref.gossip_gather_ref(idx, w, U)

    monkeypatch.setattr(ops, "gossip_gather", counted)
    return calls


def _tree_inputs(m, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.as_tensor(rng.standard_normal((m,) + shape)
                               .astype(np.float32))
    return {"b": {"w": r(3, 3, 2, 4), "v": r(7)}, "a": r(), "c": r(5, 2)}


def test_mix_tree_flat_route_is_bitwise_per_leaf_mix_rows(gather_calls):
    P = ttopology.get_schedule("undirected", 12, 2, seed=1).at(0)
    params = _tree_inputs(12)
    got = tgossip.mix_tree(P, params)
    assert gather_calls == [(12, 72 + 7 + 1 + 10)]      # one call, all leaves
    for path, leaf in tree.paths(params):
        want = tgossip.mix_rows(P.idx, P.w, leaf)
        assert torch.equal(tree.get(got, path), want), path
        assert tree.get(got, path).shape == leaf.shape
    # the plain gossip_gather itself equals mix_rows on the flat buffer
    flat = torch.cat([a.reshape(12, -1) for a in tree.leaves(params)], 1)
    assert torch.equal(ref.gossip_gather_ref(P.idx, P.w, flat),
                       tgossip.mix_rows(P.idx, P.w, flat))


def test_mix_tree_falls_back_per_leaf(gather_calls):
    params = _tree_inputs(8)
    # no sparsity (k = m): the dense contraction, leaf by leaf
    P = ttopology.get_schedule("undirected", 8, 3, seed=1).at(0)
    assert tgossip.no_sparsity(P)
    dense = tgossip.mix_tree(P, params)
    # a dense P and a bf16 leaf: leaf by leaf as well
    Pd = tgossip.mix_tree(P.dense(), params)
    P4 = ttopology.get_schedule("random", 8, 2, seed=1).at(0)
    mixed = dict(params, a=params["a"].to(torch.bfloat16))
    half = tgossip.mix_tree(P4, mixed)
    assert gather_calls == []
    for path, leaf in tree.paths(params):
        torch.testing.assert_close(tree.get(dense, path),
                                   tree.get(Pd, path))
    assert half["a"].dtype == torch.bfloat16
    assert torch.equal(half["c"], tgossip.mix_rows(P4.idx, P4.w,
                                                   params["c"]))
    assert tgossip.mix_tree(P4, {}) == {}


# ---------------------------------------------------------------------------
# the DFL baselines against the reference
# ---------------------------------------------------------------------------
def _reference_draws(sim, algo):
    key = jax.random.PRNGKey(sim.seed)
    k_data, k_init, k_run = jax.random.split(key, 3)
    data = jmake_dataset(k_data, sim.m, n_classes=sim.n_classes,
                         dist=sim.dist, alpha=sim.alpha, c=sim.c,
                         n_train=sim.n_train, n_test=sim.n_test,
                         size=sim.image_size, noise=sim.noise)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(k_init, sim.m))
    kind = "undirected" if algo in jsim.UNDIRECTED else sim.topology
    schedule = jtopology.get_schedule(kind, sim.m, sim.n_neighbors,
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


def _replay(algo, **kw):
    """Both run_experiments over the reference's draws -> (jh, th)."""
    sim_kw = dict(SIM_KW, **kw)
    sim = jsim.SimConfig(**sim_kw)
    data, stacked, batches_at, topology_at = _reference_draws(sim, algo)
    jh = jsim.run_experiment(algo, sim, eval_every=1, return_params=True)
    extra = {}
    if algo == "dispfl":
        # the reference's init_masks(PRNGKey(7)) carried across
        mask = jpartition.build_mask(
            jcnn.init_params(jax.random.PRNGKey(0), CFG_J),
            jpartition.classifier_personal)
        jalgo = jsim.build_algorithm(
            "dispfl", lambda p, b: jcnn.loss_fn(p, b, CFG_J), mask, sim)
        extra["init_state"] = convert.baseline_state_from_reference(
            jax.tree.map(np.asarray, jalgo.init(stacked)))
    th = tsim.run_experiment(
        algo, tsim.SimConfig(**sim_kw), device="cpu", eval_every=1,
        return_state=True, data=tuple(np.asarray(a) for a in data),
        init_params=jax.tree.map(np.asarray, stacked),
        topology_at=topology_at, batches_at=batches_at, **extra)
    return jh, th


def _port_eval(algo, th):
    if th["layout"] is not None:
        core = tsim.build_flat_core(algo, None, {"w": True},
                                    tsim.SimConfig(**SIM_KW))
        return core.eval_params_flat(th["state"], th["layout"])
    return tsim.build_algorithm(algo, None, None, tsim.SimConfig(**SIM_KW)
                                ).eval_params(th["state"])


@pytest.mark.parametrize("algo", DFL_ALGOS)
def test_dfl_baseline_three_rounds_match_reference(algo):
    # acc counts argmax hits over m * n_test = 96 images: one image per
    # eval (1/96) for a near-tie the parameter noise may flip
    jh, th = _replay(algo)
    assert th["round"] == jh["round"] == [1, 2, 3]
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 96 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert th["wire_bytes"] == jh["wire_bytes"] and th["wire_bytes"][0] > 0
    assert th["vtime"] == jh["vtime"] == [3.0, 6.0, 9.0]
    _close_tree(_port_eval(algo, th), jax.tree.map(np.asarray, jh["params"]),
                algo)
    st = th["state"]
    if algo == "osgp":
        # mu mixes through mix_rows: the pull tables are row-stochastic
        # with weights 1/(n+1), so mu stays 1 exactly
        assert torch.equal(st.mu, torch.ones(M))
    if algo == "dispfl":
        # masked entries stay zero through local steps and the mix
        for path, mk in tree.paths(st.masks):
            assert not tree.get(st.params, path)[mk == 0].any()


@pytest.mark.parametrize("algo,kw", [
    ("osgp", dict(codec="topk", codec_ratio=0.25)),
    ("dfedavgm", dict(codec="topk", codec_ratio=0.25,
                      participation="uniform", participation_frac=0.5))])
def test_flat_core_codec_runs_match_reference(algo, kw):
    # osgp / dfedavgm with a codec run on their flat core (DFedPGP with an
    # all-shared mask, k_v = 0, k_u = k_local + k_personal); the second
    # case samples 6 of 12 clients a round (gather, mix, scatter back)
    jh, th = _replay(algo, **kw)
    assert th["layout"] is not None and th["layout"].d_flat == 13978
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 96 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert th["wire_bytes"] == jh["wire_bytes"]
    _close_tree(_port_eval(algo, th), jax.tree.map(np.asarray, jh["params"]),
                algo)


# ---------------------------------------------------------------------------
# every algorithm of the reference runs; one gather call per DFL round
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algo", jsim.ALGOS)
def test_every_reference_algorithm_runs_in_the_port(algo, gather_calls):
    assert tsim.ALGOS == jsim.ALGOS and tsim.CFL == jsim.CFL
    assert tsim.UNDIRECTED_ALGOS == jsim.UNDIRECTED
    assert tsim.ASYNC_ALGOS == jsim.ASYNC_ALGOS
    sim = tsim.SimConfig(m=12, rounds=2, n_neighbors=2, n_train=8, n_test=4,
                         batch=4, k_local=1, k_personal=1)
    h = tsim.run_experiment(algo, sim, device="cpu", eval_every=1)
    assert np.all(np.isfinite(h["loss"])) and len(h["acc"]) == 2
    assert all(0.0 <= a <= 1.0 for a in h["acc"])
    dfl = algo not in jsim.CFL and algo != "local"
    assert len(gather_calls) == (sim.rounds if dfl else 0)
    assert (h["wire_bytes"][-1] > 0) == dfl


def test_step_gates_gate_every_local_step_of_a_baseline():
    # a baseline takes (m, k_local + k_personal) gates; all-zero gates
    # leave LocalOnly's params where they started
    sim = tsim.SimConfig(m=4, rounds=1, n_train=8, n_test=4, batch=4,
                         k_local=1, k_personal=1)
    init = tcnn.init_params(torch.Generator().manual_seed(2),
                            tcnn.CNNConfig(), (4,))
    h = tsim.run_experiment("local", sim, device="cpu", init_params=init,
                            step_gates=np.zeros((4, 2)), return_state=True)
    for path, leaf in tree.paths(h["state"].params):
        assert torch.equal(leaf, tree.get(init, path))
    with pytest.raises(ValueError, match="step_gates"):
        tsim.run_experiment("local", sim, device="cpu",
                            step_gates=np.zeros((4, 1)))


def test_run_experiment_refusals_match_reference():
    sim = dict(m=4, rounds=1, n_train=8, n_test=4, batch=4, k_local=1)
    # a codec on an algorithm without a flat engine
    for algo in ("fedavg", "dispfl", "dfedavgm-p"):
        with pytest.raises(ValueError, match="flat engines"):
            tsim.run_experiment(algo, tsim.SimConfig(codec="topk", **sim),
                                device="cpu")
    # participation without a flat engine
    for algo in ("osgp", "local"):
        with pytest.raises(ValueError, match="flat"):
            tsim.run_experiment(algo, tsim.SimConfig(
                participation="uniform", participation_frac=0.5, **sim),
                device="cpu")
    # a gossip mode that is not one of the three
    with pytest.raises(ValueError, match="matrix engines"):
        tsim.run_experiment("osgp", tsim.SimConfig(gossip="ppermute", **sim),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tsim.run_experiment("fedprox", tsim.SimConfig(**sim), device="cpu")
    with pytest.raises(ValueError, match="resident"):
        tsim.run_experiment("osgp", tsim.SimConfig(codec="topk",
                                                   resident=False, **sim),
                            device="cpu")
    for name in ("dispfl", "dfedpgp"):
        with pytest.raises(ValueError, match="no flat-buffer core"):
            tsim.build_flat_core(name, None, {}, tsim.SimConfig())
    with pytest.raises(ValueError, match="init_state"):
        tsim.run_experiment("dfedpgp", tsim.SimConfig(**sim), device="cpu",
                            init_state=object())
    # the async runtime drives the push-sum flat engines: osgp runs, a
    # CFL baseline raises the reference's ValueError
    h = tsim.run_experiment("osgp", tsim.SimConfig(runtime="async", **sim),
                            device="cpu")
    assert h["runtime"] == "async" and np.isfinite(h["final_acc"])
    with pytest.raises(ValueError, match="push-sum"):
        tsim.run_experiment("fedavg", tsim.SimConfig(runtime="async",
                                                     **sim), device="cpu")
