"""Port parity of the async regime through the simulator:
`run_experiment(..., runtime="async", device="cpu")` against the
reference's `run_experiment` (its `AsyncRuntime` loop) on the reference's
draws — data, stacked init, per-tick minibatches
(`sample_batches(fold_in(k_run, t), data, 1, batch)`), per-tick pull tables
(`schedule.at(t)`; both sides apply `to_push_sparse`) and participation
masks, injected through the port's hooks."""

import jax
import numpy as np
import pytest
import torch

from repro.core import sampling as jsampling
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.fl import simulator as jsim
from repro.models import cnn as jcnn
from repro_torch import tree
from repro_torch.fl import simulator as tsim
from repro_torch.hetero import mailbox as tmbox

torch.set_num_threads(2)
# the reference's own async simulator config (tests/test_hetero_async.py)
ASYNC_KW = dict(m=6, rounds=2, n_neighbors=2, n_train=16, n_test=8, batch=8,
                k_local=2, k_personal=1, runtime="async", hetero="tiered",
                speed_spread=3.0, push_delay_max=1)
CFG_J = jcnn.CNNConfig()
# 6 ticks of the default CNN: the engines' conv / GroupNorm / matmul sums
# run in other orders (XLA:CPU vs oneDNN), as in the sync round's parity
# test (tests/test_torch_dfedpgp.py): rtol 1e-4, atol 2e-5 on the final
# personalized models, the loss at rtol 1e-4, one test image (1/48) of
# accuracy.  The virtual clock, the local-round counts and the wire meter
# are exact.
RTOL, ATOL = 1e-4, 2e-5


def _reference_draws(sim, algo="dfedpgp"):
    """The reference's async key layout (repro/fl/simulator.py:289-290,
    :535-538): data, stacked init, and per-tick batches, pull tables and
    participation masks."""
    k_data, k_init, k_run = jax.random.split(jax.random.PRNGKey(sim.seed),
                                             3)
    data = jmake_dataset(k_data, sim.m, n_classes=sim.n_classes,
                         dist=sim.dist, alpha=sim.alpha, c=sim.c,
                         n_train=sim.n_train, n_test=sim.n_test,
                         size=sim.image_size, noise=sim.noise)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(k_init, sim.m))
    kind = "undirected" if algo in jsim.UNDIRECTED else sim.topology
    schedule = jtopology.get_schedule(kind, sim.m, sim.n_neighbors,
                                      sim.seed)
    sampler = jsampling.get_sampler(sim.participation, sim.m,
                                    sim.participation_frac, sim.seed)

    def batches_at(t):
        return jax.tree.map(np.asarray, jsample_batches(
            jax.random.fold_in(k_run, t), data, 1, sim.batch))

    def topology_at(t):
        P = schedule.at(t)
        return np.asarray(P.idx), np.asarray(P.w)

    hooks = dict(data=tuple(np.asarray(a) for a in data),
                 init_params=jax.tree.map(np.asarray, stacked),
                 batches_at=batches_at, topology_at=topology_at)
    if sampler is not None:
        hooks["sampled_at"] = sampler.active_mask
    return hooks


def _pair(algo, port_kw=None, **kw):
    """The reference's async run and the port's on its draws (the port's
    SimConfig takes `port_kw` on top) -> (histories, the draws)."""
    sim_j = jsim.SimConfig(**dict(ASYNC_KW, **kw))
    hooks = _reference_draws(sim_j, algo)
    jh = jsim.run_experiment(algo, sim_j, eval_every=1, return_params=True)
    th = tsim.run_experiment(algo, tsim.SimConfig(
        **dict(ASYNC_KW, **kw, **(port_kw or {}))), device="cpu",
        eval_every=1, return_state=True, **hooks)
    return jh, th, hooks


def _hold(jh, th, acc_tol=1 / 48 + 1e-9):
    assert th["runtime"] == jh["runtime"] == "async"
    assert th["round"] == jh["round"]
    assert th["vtime"] == jh["vtime"]
    assert th["wire_bytes"] == jh["wire_bytes"]
    np.testing.assert_allclose(th["mean_local_rounds"],
                               jh["mean_local_rounds"], rtol=1e-6)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=RTOL)
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=acc_tol)
    ev = th["engine"].eval_params(th["state"])
    for path, leaf in tree.paths(ev):
        np.testing.assert_allclose(
            leaf.numpy(), np.asarray(tree.get(jh["params"], path)),
            rtol=RTOL, atol=ATOL, err_msg="/".join(path))
    assert len(th["round_s"]) == ASYNC_KW["rounds"]


@pytest.mark.parametrize("algo", ["dfedpgp", "osgp", "dfedavgm"])
def test_async_run_matches_reference(algo):
    jh, th, _ = _pair(algo)
    _hold(jh, th)
    assert th["vtime"] == sorted(th["vtime"]) and th["vtime"][-1] == 6.0
    assert th["mean_local_rounds"][-1] > 0.0
    st = th["state"]
    np.testing.assert_allclose(float(th["engine"].mass_total(st)),
                               ASYNC_KW["m"], rtol=1e-5)


def test_async_stale_discount_matches_reference():
    jh, th, _ = _pair("dfedpgp", stale_discount=True, push_delay_max=2,
                      mailbox_depth=3)
    _hold(jh, th)


@pytest.mark.parametrize("algo", ["dfedpgp", "osgp", "dfedavgm"])
def test_async_topk_codec_matches_reference(algo):
    # the port's codec fires take the kernel route (gossip_gather over the
    # old references + topk_gather over the payload, plain versions on the
    # CPU); the reference's the sparse route, which is the same sum
    # split in two
    jh, th, hooks = _pair(algo, port_kw=dict(gossip="pallas"),
                          codec="topk", codec_gamma=0.5)
    _hold(jh, th)
    st = th["state"]
    assert st.ef is not None and float(st.ef.abs().sum()) > 0.0
    # the lossy payload crosses fewer bytes than the identity codec
    ident = tsim.run_experiment(algo, tsim.SimConfig(
        **dict(ASYNC_KW, codec="identity")), device="cpu", eval_every=1,
        **hooks)
    assert 0 < th["wire_bytes"][-1] < ident["wire_bytes"][-1]


def test_identity_codec_is_the_codec_free_run_bitwise():
    hooks = _reference_draws(jsim.SimConfig(**ASYNC_KW))
    runs = [tsim.run_experiment("dfedpgp", tsim.SimConfig(
        **dict(ASYNC_KW, codec=c)), device="cpu", eval_every=1,
        return_state=True, **hooks) for c in (None, "identity")]
    a, b = (r["state"] for r in runs)
    assert a.ef is None and b.ef is None
    for x, y in ((a.flat, b.flat), (a.mu, b.mu),
                 (a.opt_u.momentum, b.opt_u.momentum),
                 (a.mail.slots_flat, b.mail.slots_flat),
                 (a.mail.inbox_flat, b.mail.inbox_flat)):
        assert torch.equal(x, y)
    assert runs[0]["acc"] == runs[1]["acc"]
    assert runs[0]["wire_bytes"] == runs[1]["wire_bytes"]


def test_async_participation_matches_reference_and_conserves_mass():
    """25% participation: the reference's sampler masks tick by tick;
    dormant clients' rows freeze while mail piles into their inboxes, and
    the total push-sum weight stays m."""
    jh, th, _ = _pair("dfedpgp", participation="uniform",
                      participation_frac=0.25)
    _hold(jh, th)
    st = th["state"]
    np.testing.assert_allclose(float(th["engine"].mass_total(st)),
                               ASYNC_KW["m"], rtol=1e-5)
    _, mail_mu = tmbox.in_flight(st.mail)
    assert float(mail_mu.sum()) > 0.0


def test_all_ones_participation_gate_is_no_gate():
    hooks = _reference_draws(jsim.SimConfig(**ASYNC_KW))
    base = tsim.run_experiment("dfedpgp", tsim.SimConfig(**ASYNC_KW),
                               device="cpu", eval_every=1,
                               return_state=True, **hooks)
    gated = tsim.run_experiment(
        "dfedpgp", tsim.SimConfig(**ASYNC_KW), device="cpu", eval_every=1,
        return_state=True,
        sampled_at=lambda t: np.ones(ASYNC_KW["m"], bool), **hooks)
    assert torch.equal(base["state"].flat, gated["state"].flat)
    assert torch.equal(base["state"].mu, gated["state"].mu)
    assert base["acc"] == gated["acc"]
