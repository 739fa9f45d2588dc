"""Port parity of the resident DFedPGP round and the simulator: the same
initial parameters, neighbor tables and minibatches (drawn by the JAX
reference) go through `repro.core.dfedpgp` and `repro_torch.core.dfedpgp`,
and through both `run_experiment`s."""
import jax
import jax.numpy as jnp
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
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import partition as tpartition
from repro_torch.core.topology import SparseTopology
from repro_torch.fl import simulator as tsim
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGD as TSGD
from repro_torch.serve import make_cnn_server

torch.set_num_threads(2)
M = 8
SIM_KW = dict(m=M, rounds=3, n_neighbors=3, n_train=16, n_test=8, batch=8,
              k_local=2, k_personal=1)
CFG_J = jcnn.CNNConfig()
CFG_T = tcnn.CNNConfig()
# Both engines compute in f32, but XLA:CPU and oneDNN sum convolutions,
# GroupNorm and matmuls in other orders and XLA may contract multiply-adds
# into FMAs; 9 SGD steps (3 rounds of 1 + 2) carry that ~1e-7 relative
# noise forward.  Measured max abs difference at this size: 4.8e-7 on the
# buffer and momenta (mu is exact); tolerance rtol 1e-4, atol 2e-5.
RTOL, ATOL = 1e-4, 2e-5


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
    return ({"v": {k: a[:, :kv] for k, a in batches.items()},
             "u": {k: a[:, kv:] for k, a in batches.items()}})


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_tree(t_tree, j_tree, what):
    for path, leaf in tree.paths(t_tree):
        ref = j_tree
        for key in path:
            ref = ref[key]
        _close(leaf, ref, what + "/" + "/".join(path))


@pytest.fixture(scope="module")
def round_pair():
    """3 resident rounds of each engine from the reference's draws."""
    sim = jsim.SimConfig(**SIM_KW)
    data, stacked, batches_at, topology_at = _reference_draws(sim)

    def jloss(p, batch):
        return jcnn.loss_fn(p, batch, CFG_J)

    mask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                  CFG_J),
                                 jpartition.classifier_personal)
    jalgo = jsim.build_algorithm("dfedpgp", jloss, mask, sim)
    jstate, jlayout = jalgo.init_flat(stacked)
    jround = jax.jit(lambda s, P, b: jalgo.round_fn_flat(s, P, b, jlayout))

    def tloss(p, batch):
        return tcnn.loss_fn(p, batch, CFG_T)

    tstacked = convert.params_from_reference(jax.tree.map(np.asarray,
                                                          stacked))
    tmask = tpartition.build_mask(tstacked, tpartition.classifier_personal)
    opt = TSGD(lr=sim.lr, momentum=sim.momentum,
               weight_decay=sim.weight_decay)
    talgo = tdfedpgp.DFedPGP(loss_fn=tloss, mask=tmask, opt_u=opt,
                             opt_v=opt, k_v=sim.k_personal, k_u=sim.k_local,
                             lr_decay=sim.lr_decay)
    tstate, tlayout = talgo.init_flat(tstacked, device="cpu")
    kv = sim.k_personal
    for r in range(sim.rounds):
        b = batches_at(r)
        idx, w = topology_at(r)
        jstate, jm = jround(jstate, jtopology.SparseTopology(
            jnp.asarray(idx), jnp.asarray(w)), _split(
                jax.tree.map(jnp.asarray, b), kv))
        tb = {"x": torch.from_numpy(np.array(b["x"])),
              "y": torch.from_numpy(np.array(b["y"]))}
        tstate, tm = talgo.round_fn_flat(
            tstate, SparseTopology(torch.from_numpy(np.array(idx)),
                                   torch.from_numpy(np.array(w))),
            _split(tb, kv), tlayout)
    return dict(jalgo=jalgo, jstate=jstate, jlayout=jlayout, jm=jm,
                talgo=talgo, tstate=tstate, tlayout=tlayout, tm=tm)


def test_round_fn_flat_three_rounds_match_reference(round_pair):
    js, ts = round_pair["jstate"], round_pair["tstate"]
    assert int(ts.round) == int(js.round) == 3
    _close(ts.flat, js.flat, "flat")
    _close(ts.mu, js.mu, "mu")
    _close(ts.opt_u.momentum, js.opt_u.momentum, "opt_u")
    _close_tree(ts.personal, jax.tree.map(np.asarray, js.personal),
                "personal")
    _close_tree(ts.opt_v.momentum,
                jax.tree.map(np.asarray, js.opt_v.momentum), "opt_v")
    for key in ("loss_v", "loss_u", "mu_min", "mu_max"):
        np.testing.assert_allclose(float(round_pair["tm"][key]),
                                   float(round_pair["jm"][key]), rtol=RTOL,
                                   err_msg=key)


def test_eval_params_flat_matches_reference(round_pair):
    jp = round_pair["jalgo"].eval_params_flat(round_pair["jstate"],
                                              round_pair["jlayout"])
    tp = round_pair["talgo"].eval_params_flat(round_pair["tstate"],
                                              round_pair["tlayout"])
    _close_tree(tp, jax.tree.map(np.asarray, jp), "eval")


def test_run_experiment_replay_tracks_reference_history():
    # acc is a count of argmax hits over m * n_test = 64 test images: the
    # parameter noise above can flip a near-tie, so allow one image per
    # eval (1/64); the mean loss agrees to rtol 1e-4
    sim = jsim.SimConfig(**SIM_KW)
    jh = jsim.run_experiment("dfedpgp", sim, eval_every=1)
    data, stacked, batches_at, topology_at = _reference_draws(sim)
    th = tsim.run_experiment(
        "dfedpgp", tsim.SimConfig(**SIM_KW), device="cpu", eval_every=1,
        data=tuple(np.asarray(a) for a in data),
        init_params=jax.tree.map(np.asarray, stacked),
        topology_at=topology_at, batches_at=batches_at)
    assert th["round"] == jh["round"] == [1, 2, 3]
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 64 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert abs(th["final_acc"] - jh["final_acc"]) <= 1 / 64 + 1e-9
    assert len(th["round_s"]) == 3 and th["device"] == "cpu"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = tsim.SimConfig(m=4, rounds=1, n_neighbors=2, n_train=8, n_test=4,
                         batch=4, k_local=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run_experiment("dfedpgp", sim)
    stacked = tcnn.init_params(torch.Generator().manual_seed(0), CFG_T, (4,))
    mask = tpartition.build_mask(stacked, tpartition.classifier_personal)
    algo = tdfedpgp.DFedPGP(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                            mask=mask)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo.init_flat(stacked)
    state, layout = algo.init_flat(stacked, device="cpu")
    assert state.flat.device.type == "cpu" and layout.d_flat == 13328
    from repro_torch.serve import from_train_state
    sstate = from_train_state(state, layout=layout)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cnn_server(sstate, CFG_T)
    h = tsim.run_experiment("dfedpgp", sim, device="cpu")
    assert np.isfinite(h["final_acc"]) and len(h["acc"]) == 1


def test_unported_simconfig_knobs_raise():
    # every SimConfig knob is ported: spec= is taken, and (as in the
    # reference) a spec describing another algorithm raises
    from repro_torch.spec import make_algo_spec
    assert not hasattr(tsim, "_UNPORTED")
    with pytest.raises(ValueError, match="one spec"):
        tsim.run_experiment("dfedpgp", tsim.SimConfig(
            m=4, spec=make_algo_spec("osgp")), device="cpu")


ASYNC_TINY = dict(m=4, rounds=1, n_neighbors=2, n_train=8, n_test=4,
                  batch=4, k_local=1, k_personal=1, runtime="async")


def _build_async(**kw):
    from repro_torch.hetero import profiles
    from repro_torch.hetero.runtime import AsyncRuntime
    stacked = tcnn.init_params(torch.Generator().manual_seed(0), CFG_T,
                               (4,))
    mask = tpartition.build_mask(stacked, tpartition.classifier_personal)
    algo = tdfedpgp.DFedPGP(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                            mask=mask, **kw.pop("algo", {}))
    return AsyncRuntime.build(algo, stacked, kw.pop("profile", profiles
                                                    .uniform(4)),
                              device="cpu", **kw)


# the reference's async rejections (tests/test_hetero_async.py:271, :387)
@pytest.mark.parametrize("case,match", [
    ("fedavg", "push-sum"), ("step_gates", "step_gates"),
    ("warp", "runtime"), ("depth", "depth"), ("auto", "codec_gamma"),
    ("mix_fn", "mix_fn")])
def test_async_rejections(case, match):
    sim = tsim.SimConfig(**ASYNC_TINY)
    with pytest.raises(ValueError, match=match):
        if case == "fedavg":
            tsim.run_experiment("fedavg", sim, device="cpu")
        elif case == "step_gates":
            tsim.run_experiment("dfedpgp", sim, device="cpu",
                                step_gates=np.ones((4, 2), np.float32))
        elif case == "warp":
            tsim.run_experiment("dfedpgp", tsim.SimConfig(
                **dict(ASYNC_TINY, runtime="warp")), device="cpu")
        elif case == "depth":
            from repro_torch.hetero import profiles
            _build_async(profile=profiles.tiered(4, push_delay_max=5),
                         depth=2)
        elif case == "auto":
            tsim.run_experiment("dfedpgp", tsim.SimConfig(
                **dict(ASYNC_TINY, codec="topk", codec_gamma="auto")),
                device="cpu")
        else:
            _build_async(algo=dict(mix_fn_flat=lambda f, mu, r, P: (f, mu)))


def test_unported_algorithms_and_dfedpgp_knobs_raise():
    # the async leg of the flat cores runs (with a codec too); a baseline
    # without one raises the reference's ValueError
    for algo, kw in (("osgp", {}), ("dfedavgm", dict(codec="topk"))):
        h = tsim.run_experiment(algo, tsim.SimConfig(**ASYNC_TINY, **kw),
                                device="cpu")
        assert h["runtime"] == "async" and np.isfinite(h["final_acc"])
    with pytest.raises(ValueError, match="push-sum"):
        tsim.run_experiment("dispfl", tsim.SimConfig(**ASYNC_TINY),
                            device="cpu")
    mask = {"a": True}
    # the grad hooks are ported (Regime B): both are taken, and the
    # resident rounds refuse a tree hook without its row twin, as the
    # reference's do
    for kw in (dict(grad_hook_flat=print), dict(grad_hook=print)):
        algo = tdfedpgp.DFedPGP(loss_fn=print, mask=mask, **kw)
        assert all(getattr(algo, k) is print for k in kw)
    with pytest.raises(ValueError, match="grad_hook_flat"):
        tdfedpgp.DFedPGP(loss_fn=print, mask=mask,
                         grad_hook=print)._check_flat_hooks()
    # telemetry is ported
    assert tdfedpgp.DFedPGP(loss_fn=print, mask=mask,
                            telemetry=True).telemetry
    # the reference's three gossip modes are all accepted; others raise
    for mode in ("dense", "sparse", "pallas"):
        assert tdfedpgp.DFedPGP(loss_fn=print, mask=mask,
                                gossip=mode).gossip == mode
    with pytest.raises(ValueError, match="known"):
        tdfedpgp.DFedPGP(loss_fn=print, mask=mask, gossip="ppermute")
