"""Port parity of partial participation: the sampler, the hetero profiles
and step gates, the induced subgraph, the gossip_scatter plain version,
the sampled resident round and the sampled `run_experiment` — each against
the JAX reference (`repro.core.sampling`, `repro.hetero.profiles`,
`repro.core.topology`, `repro.kernels`, `repro.core.dfedpgp`,
`repro.fl.simulator`) on the same numpy inputs.

The CUDA gossip_scatter kernel itself runs only on a GPU; `chip_smoke.py`
holds it against `gossip_scatter_ref` there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpartition
from repro.core import sampling as jsampling
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.fl import simulator as jsim
from repro.hetero import profiles as jprofiles
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import partition as tpartition
from repro_torch.core import sampling as tsampling
from repro_torch.core import topology as ttopology
from repro_torch.fl import simulator as tsim
from repro_torch.hetero import profiles as tprofiles
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGD as TSGD
from repro_torch.optim import SGDState as TSGDState

torch.set_num_threads(2)
M = 8
SIM_KW = dict(m=M, rounds=3, n_neighbors=3, n_train=16, n_test=8, batch=8,
              k_local=2, k_personal=1)
CFG_J = jcnn.CNNConfig()
CFG_T = tcnn.CNNConfig()
# The local steps agree to conv / GroupNorm summation order (XLA:CPU vs
# oneDNN), carried through 9 SGD steps: the same bound as the resident
# round's parity test (tests/test_torch_dfedpgp.py), rtol 1e-4, atol 2e-5.
# The sampler, the profiles, the induced tables and the scatter are exact.
RTOL, ATOL = 1e-4, 2e-5


def _topo(idx, w):
    return ttopology.SparseTopology(torch.as_tensor(np.array(idx)),
                                    torch.as_tensor(np.array(w)))


def _np_profile(p):
    return {name: np.asarray(a) for name, a in zip(p._fields, p)}


# ---------------------------------------------------------------------------
# sampler and profiles: exact replay of the reference's numpy streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("m,frac", [(8, 0.5), (32, 0.25), (13, 0.3)])
def test_uniform_sampler_ids_equal_reference(seed, m, frac):
    js = jsampling.ParticipationSampler("uniform", m, frac, seed)
    ts = tsampling.get_sampler("uniform", m, frac, seed)
    assert ts.n_active == js.n_active
    for t in range(6):
        got = ts.active_at(t)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, js.active_at(t))
        np.testing.assert_array_equal(ts.active_mask(t), js.active_mask(t))


@pytest.mark.parametrize("kind,kw", [
    ("tiered", dict(spread=2.0, availability=0.5, seed=3)),
    ("tiered", dict(spread=5.0, push_delay_max=2, availability=0.7, seed=1)),
    ("lognormal", dict(spread=4.0, availability=0.4, seed=5))])
def test_trace_sampler_ids_equal_reference(kind, kw):
    m = 16
    jp = jprofiles.make_profile(kind, m, **kw)
    tp = tprofiles.make_profile(kind, m, **kw)
    for seed in (0, 7):
        js = jsampling.ParticipationSampler("trace", m, 0.25, seed, jp)
        ts = tsampling.get_sampler("trace", m, 0.25, seed, tp)
        for t in range(10):
            np.testing.assert_array_equal(ts.active_at(t), js.active_at(t))


@pytest.mark.parametrize("kind,kw", [
    ("uniform", {}), ("tiered", dict(spread=5.0)),
    ("tiered", dict(spread=3.0, push_delay_max=3, availability=0.6,
                    seed=4)),
    ("lognormal", dict(spread=5.0, push_delay_max=2, seed=2)),
    ("lognormal", dict(spread=8.0, availability=0.5, seed=9))])
def test_profiles_equal_reference(kind, kw):
    m = 12
    tp = tprofiles.make_profile(kind, m, **kw)
    jp = _np_profile(jprofiles.make_profile(kind, m, **kw))
    for name, arr in jp.items():
        got = getattr(tp, name)
        assert got.dtype == arr.dtype, name
        np.testing.assert_array_equal(got, arr, err_msg=name)
    assert tp.m == m
    # the profile carried across from the reference's arrays is the same
    np.testing.assert_array_equal(
        convert.profile_from_reference(**jp).avail_phase, tp.avail_phase)
    for t in (0, 3, 17):
        np.testing.assert_array_equal(
            tprofiles.time_to_available(tp, t),
            jprofiles.time_to_available(jprofiles.make_profile(kind, m, **kw),
                                        t))


def test_tier_gates_and_validation_equal_reference():
    for m, k in ((8, 2), (10, 5), (7, 3)):
        np.testing.assert_array_equal(tprofiles.tier_gates(m, k),
                                      jprofiles.tier_gates(m, k))
    g = tprofiles.validate_step_gates(np.ones((4, 5)), 4, 3)
    assert g.dtype == np.float32 and g.shape == (4, 5)
    for bad in (np.ones((3, 5)), np.ones((4, 2)), np.ones(4)):
        with pytest.raises(ValueError, match="step_gates"):
            tprofiles.validate_step_gates(bad, 4, 3)
    with pytest.raises(ValueError, match="uniform"):
        tprofiles.make_profile("uniform", 4, availability=0.5)
    with pytest.raises(ValueError, match="avail_duty"):
        tprofiles.validate_profile(tprofiles.uniform(4)._replace(
            avail_duty=np.zeros(4, np.float32)), 4)


def test_sampler_validation_and_registry():
    with pytest.raises(ValueError, match="kind"):
        tsampling.ParticipationSampler("lottery", m=4)
    with pytest.raises(ValueError, match="frac"):
        tsampling.ParticipationSampler("uniform", m=4, frac=0.0)
    with pytest.raises(ValueError, match="profile"):
        tsampling.ParticipationSampler("trace", m=4, frac=0.5)
    with pytest.raises(ValueError, match="participation_frac"):
        tsampling.get_sampler("full", 4, 0.5)
    assert tsampling.get_sampler("full", 4) is None
    full = tsampling.ParticipationSampler("full", m=9)
    np.testing.assert_array_equal(full.active_at(5), np.arange(9))


# ---------------------------------------------------------------------------
# induced subgraph: the reference's tables bit for bit
# ---------------------------------------------------------------------------
def _tables(seed, m, k):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, (m, k)).astype(np.int32)
    idx[:, 0] = np.arange(m)
    w = rng.random((m, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    if seed % 2:
        w[:, 1] = 0.0                  # zero-weight padding entries
    return idx, w


@pytest.mark.parametrize("renorm", ["row", "col"])
@pytest.mark.parametrize("seed", range(4))
def test_induced_subgraph_equals_reference_bitwise(renorm, seed):
    cases = [_tables(seed, 13, 5)]
    P = jtopology.get_schedule("random", 20, 4, seed).at(seed)
    cases.append((np.asarray(P.idx), np.asarray(P.w)))
    rng = np.random.default_rng(100 + seed)
    for idx, w in cases:
        m = idx.shape[0]
        jP = jtopology.SparseTopology(jnp.asarray(idx), jnp.asarray(w))
        for n in (1, m // 3, m // 2, m):
            active = np.sort(rng.choice(m, n, replace=False)).astype(np.int32)
            want = jtopology.induced_subgraph(jP, jnp.asarray(active), renorm)
            got = ttopology.induced_subgraph(_topo(idx, w), active, renorm)
            assert got.idx.dtype == torch.int32
            assert got.w.dtype == torch.float32
            np.testing.assert_array_equal(got.idx.numpy(),
                                          np.asarray(want.idx))
            np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
        # sample-all: the scale factor is exactly 1.0, the weights unchanged
        # (zero-weight entries re-pad to (self, 0))
        full = ttopology.induced_subgraph(_topo(idx, w), np.arange(m), renorm)
        assert torch.equal(full.w, torch.from_numpy(np.array(w)))
        live = w > 0
        np.testing.assert_array_equal(full.idx.numpy()[live], idx[live])


def test_schedule_induced_and_renorm_guard():
    sched = ttopology.get_schedule("random", 10, 3, seed=2)
    active = np.array([1, 4, 5, 9], np.int32)
    a = sched.induced(3, active)
    b = ttopology.induced_subgraph(sched.at(3), active, "row")
    assert torch.equal(a.idx, b.idx) and torch.equal(a.w, b.w)
    # row-stochastic rows keep their sum in the pull form
    np.testing.assert_allclose(a.w.sum(1).numpy(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="renorm"):
        ttopology.induced_subgraph(sched.at(0), active, "both")


# ---------------------------------------------------------------------------
# gossip_scatter plain version: the reference's kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,d", [(5, 3), (13, 130), (7, 257), (32, 64)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_gossip_scatter_plain_equals_reference_kernel(m, d, accumulate):
    # the shapes of tests/test_sampling.py; set mode is an exact copy and
    # accumulate one f32 add per element, so both sides agree bit for bit
    rng = np.random.default_rng(m * 100 + d)
    U = rng.standard_normal((m, d)).astype(np.float32)
    n = max(1, m // 3)
    rows = np.sort(rng.choice(m, size=n, replace=False)).astype(np.int32)
    X = rng.standard_normal((n, d)).astype(np.float32)
    want = jops.gossip_scatter(jnp.asarray(rows), jnp.asarray(X),
                               jnp.asarray(U), accumulate=accumulate,
                               force="pallas")
    Ut = torch.as_tensor(U.copy())
    ptr = Ut.data_ptr()
    got = tref.gossip_scatter_ref(torch.as_tensor(rows), torch.as_tensor(X),
                                  Ut, accumulate)
    # written in place, as the CUDA kernel writes
    assert got.data_ptr() == ptr and got is Ut
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(jref.gossip_scatter_ref(jnp.asarray(rows), jnp.asarray(X),
                                           jnp.asarray(U), accumulate)),
        got.numpy())
    dormant = np.setdiff1d(np.arange(m), rows)
    np.testing.assert_array_equal(got.numpy()[dormant], U[dormant])


def test_gossip_scatter_plain_bf16_buffer_equals_reference():
    # X in f32 into a bf16 U: both sides round X to bf16 first, then (in
    # accumulate mode) add in f32 and round once: bit for bit
    rng = np.random.default_rng(0)
    U = rng.standard_normal((9, 70)).astype(np.float32)
    X = rng.standard_normal((3, 70)).astype(np.float32)
    rows = np.array([0, 4, 8], np.int32)
    for acc in (False, True):
        want = jops.gossip_scatter(jnp.asarray(rows), jnp.asarray(X),
                                   jnp.asarray(U).astype(jnp.bfloat16),
                                   accumulate=acc, force="pallas")
        got = tops.gossip_scatter(torch.as_tensor(rows), torch.as_tensor(X),
                                  torch.as_tensor(U).to(torch.bfloat16),
                                  accumulate=acc)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # n = 0 leaves U as it was
    Ut = torch.as_tensor(U.copy())
    out = tops.gossip_scatter(torch.zeros(0, dtype=torch.int32),
                              torch.zeros((0, 70)), Ut)
    assert out is Ut and torch.equal(out, torch.as_tensor(U))


# ---------------------------------------------------------------------------
# the sampled resident round
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


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_tree(t_tree, j_tree, what):
    for path, leaf in tree.paths(t_tree):
        ref = j_tree
        for key in path:
            ref = ref[key]
        _close(leaf, ref, what + "/" + "/".join(path))


def _port_algo(sim, stacked):
    tstacked = convert.params_from_reference(jax.tree.map(np.asarray,
                                                          stacked))
    tmask = tpartition.build_mask(tstacked, tpartition.classifier_personal)
    opt = TSGD(lr=sim.lr, momentum=sim.momentum,
               weight_decay=sim.weight_decay)
    algo = tdfedpgp.DFedPGP(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                            mask=tmask, opt_u=opt, opt_v=opt,
                            k_v=sim.k_personal, k_u=sim.k_local,
                            lr_decay=sim.lr_decay)
    return algo, tstacked


def _clone_state(s):
    def clone(x):
        return tree.tree_map(torch.clone, x) if isinstance(x, dict) \
            else x.clone()
    return tdfedpgp.FlatDFedPGPState(
        clone(s.flat), clone(s.personal), clone(s.mu),
        TSGDState(clone(s.opt_u.momentum)), TSGDState(clone(s.opt_v.momentum)),
        clone(s.round))


@pytest.fixture(scope="module")
def sampled_pair():
    """3 sampled rounds at frac 0.5 of each engine from the reference's
    init, tables, batches and active sets."""
    sim = jsim.SimConfig(**SIM_KW)
    data, stacked, batches_at, topology_at = _reference_draws(sim)
    mask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                  CFG_J),
                                 jpartition.classifier_personal)
    jalgo = jsim.build_algorithm(
        "dfedpgp", lambda p, b: jcnn.loss_fn(p, b, CFG_J), mask, sim)
    jstate, jlayout = jalgo.init_flat(stacked)
    jround = jax.jit(lambda s, P, a, b: jalgo.round_fn_sampled(
        s, P, a, b, jlayout))
    talgo, tstacked = _port_algo(sim, stacked)
    tstate, tlayout = talgo.init_flat(tstacked, device="cpu")
    init = _clone_state(tstate)
    sampler = tsampling.get_sampler("uniform", M, 0.5, seed=2)
    ever = np.zeros(M, bool)
    kv = sim.k_personal
    for r in range(sim.rounds):
        active = sampler.active_at(r)
        ever[active] = True
        b = {k: a[active] for k, a in batches_at(r).items()}
        idx, w = topology_at(r)
        jP = jtopology.induced_subgraph(
            jtopology.SparseTopology(jnp.asarray(idx), jnp.asarray(w)),
            jnp.asarray(active), "row")
        jstate, jm = jround(jstate, jP, jnp.asarray(active),
                            _split(jax.tree.map(jnp.asarray, b), kv))
        tP = ttopology.induced_subgraph(_topo(idx, w), active, "row")
        tb = {k: torch.from_numpy(np.array(a)) for k, a in b.items()}
        flat_before = tstate.flat
        tstate, tm = talgo.round_fn_sampled(tstate, tP, active,
                                            _split(tb, kv), tlayout)
        # the buffer is written in place: the new state's IS the old one
        assert tstate.flat is flat_before
    return dict(jstate=jstate, jm=jm, tstate=tstate, tm=tm, init=init,
                ever=ever, n_active=sampler.n_active)


def test_round_fn_sampled_three_rounds_match_reference(sampled_pair):
    js, ts = sampled_pair["jstate"], sampled_pair["tstate"]
    assert int(ts.round) == int(js.round) == 3
    _close(ts.flat, js.flat, "flat")
    _close(ts.mu, js.mu, "mu")
    _close(ts.opt_u.momentum, js.opt_u.momentum, "opt_u")
    _close_tree(ts.personal, jax.tree.map(np.asarray, js.personal),
                "personal")
    _close_tree(ts.opt_v.momentum,
                jax.tree.map(np.asarray, js.opt_v.momentum), "opt_v")
    tm, jm = sampled_pair["tm"], sampled_pair["jm"]
    assert tm["n_active"] == int(jm["n_active"]) == sampled_pair["n_active"]
    for key in ("loss_v", "loss_u", "mu_min", "mu_max"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL,
                                   err_msg=key)


def test_round_fn_sampled_freezes_dormant_rows(sampled_pair):
    """Every client dormant through the 3 rounds keeps its rows bit for bit
    (the initial state was cloned before the in-place rounds); active rows
    moved; mu sums to m (row-stochastic pull mix)."""
    ts, init, ever = (sampled_pair[k] for k in ("tstate", "init", "ever"))
    dormant = torch.as_tensor(~ever)
    assert dormant.any() and (~dormant).any()
    assert torch.equal(ts.flat[dormant], init.flat[dormant])
    assert torch.equal(ts.mu[dormant], init.mu[dormant])
    assert torch.equal(ts.opt_u.momentum[dormant],
                       init.opt_u.momentum[dormant])
    for path, leaf in tree.paths(ts.personal):
        assert torch.equal(leaf[dormant], tree.get(init.personal,
                                                   path)[dormant])
    for path, leaf in tree.paths(ts.opt_v.momentum):
        assert torch.equal(leaf[dormant], tree.get(init.opt_v.momentum,
                                                   path)[dormant])
    assert (ts.flat[~dormant] != init.flat[~dormant]).any()
    np.testing.assert_allclose(float(ts.mu.sum()), M, rtol=1e-6)


def test_sample_all_equals_round_fn_flat_bitwise():
    """Every client active: gather, induced re-normalization (factor
    exactly 1.0) and scatter reduce to round_fn_flat, bit for bit on the
    CPU over 2 rounds."""
    sim = jsim.SimConfig(**SIM_KW)
    _, stacked, batches_at, topology_at = _reference_draws(sim)
    talgo, tstacked = _port_algo(sim, stacked)
    s_full, layout = talgo.init_flat(tstacked, device="cpu")
    s_samp = _clone_state(s_full)
    active = tsampling.ParticipationSampler("full", M).active_at(0)
    for r in range(2):
        b = _split({k: torch.from_numpy(np.array(a))
                    for k, a in batches_at(r).items()}, sim.k_personal)
        P = _topo(*topology_at(r))
        s_full, m_full = talgo.round_fn_flat(s_full, P, b, layout)
        s_samp, m_samp = talgo.round_fn_sampled(
            s_samp, ttopology.induced_subgraph(P, active), active, b, layout)
        assert torch.equal(m_full["loss_u"], m_samp["loss_u"])
    assert torch.equal(s_full.flat, s_samp.flat)
    assert torch.equal(s_full.mu, s_samp.mu)
    assert torch.equal(s_full.opt_u.momentum, s_samp.opt_u.momentum)
    for path, leaf in tree.paths(s_full.personal):
        assert torch.equal(leaf, tree.get(s_samp.personal, path))
    for path, leaf in tree.paths(s_full.opt_v.momentum):
        assert torch.equal(leaf, tree.get(s_samp.opt_v.momentum, path))


def test_round_fn_sampled_refuses_mix_overrides():
    stacked = tcnn.init_params(torch.Generator().manual_seed(0), CFG_T, (2,))
    algo = tdfedpgp.DFedPGP(
        loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
        mask=tpartition.build_mask(stacked, tpartition.classifier_personal),
        mix_fn_flat=lambda flat, mu, rnd, P: (flat, mu))
    state, layout = algo.init_flat(stacked, device="cpu")
    with pytest.raises(ValueError, match="compact working set"):
        algo.round_fn_sampled(state, None, np.array([0], np.int32), {},
                              layout)


# ---------------------------------------------------------------------------
# run_experiment: sampled and step-gated replays against the reference
# ---------------------------------------------------------------------------
def _replay(sim_kw, **run_kw):
    sim = jsim.SimConfig(**sim_kw)
    jh = jsim.run_experiment("dfedpgp", sim, eval_every=1,
                             step_gates=run_kw.get("step_gates"))
    data, stacked, batches_at, topology_at = _reference_draws(sim)
    th = tsim.run_experiment(
        "dfedpgp", tsim.SimConfig(**sim_kw), device="cpu", eval_every=1,
        data=tuple(np.asarray(a) for a in data),
        init_params=jax.tree.map(np.asarray, stacked),
        topology_at=topology_at, batches_at=batches_at, **run_kw)
    return jh, th


@pytest.mark.parametrize("extra", [
    dict(participation="uniform", participation_frac=0.5),
    dict(participation="trace", participation_frac=0.5, hetero="tiered",
         availability=0.5, seed=2)])
def test_run_experiment_sampled_replay_tracks_reference(extra):
    # acc counts argmax hits over m * n_test = 64 images: the parameter
    # noise above can flip a near-tie, so one image (1/64) per eval; the
    # mean loss to rtol 1e-4
    jh, th = _replay(dict(SIM_KW, **extra))
    assert th["round"] == jh["round"] == [1, 2, 3]
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 64 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)


def test_run_experiment_step_gates_replay_tracks_reference():
    gates = tprofiles.tier_gates(M, SIM_KW["k_local"] + 1)
    jh, th = _replay(SIM_KW, step_gates=gates)
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 64 + 1e-9)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    with pytest.raises(ValueError, match="step_gates"):
        tsim.run_experiment("dfedpgp", tsim.SimConfig(**SIM_KW),
                            device="cpu", step_gates=np.ones((M, 1)))


def test_run_experiment_sampling_guards():
    with pytest.raises(ValueError, match="resident"):
        tsim.run_experiment("dfedpgp", tsim.SimConfig(
            m=4, participation="uniform", participation_frac=0.5,
            resident=False), device="cpu")
    with pytest.raises(ValueError, match="participation_frac"):
        tsim.run_experiment("dfedpgp", tsim.SimConfig(
            m=4, participation_frac=0.5), device="cpu")
