"""Port parity of the serve path: `from_train_state` and `serve_logits` of
`repro_torch.serve` against `repro.serve` on one trained-like state, and
the fused path against the per-request `serve_naive` baseline."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import partition as jpartition
from repro.fl import simulator as jsim
from repro.models import cnn as jcnn
from repro_torch import convert, tree
from repro_torch import serve as tserve
from repro_torch.core import partition as tpartition
from repro_torch.core.gossip import FlatLayout
from repro_torch.models import cnn as tcnn

torch.set_num_threads(2)
M, B = 5, 12
CFG_J = jcnn.CNNConfig()
CFG_T = tcnn.CNNConfig()


def _np(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def states():
    """One trained-like resident state (perturbed buffer and mu, as if
    mid-training) in both engines, plus a mixed-user request batch."""
    def jloss(p, batch):
        return jcnn.loss_fn(p, batch, CFG_J)

    mask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                  CFG_J),
                                 jpartition.classifier_personal)
    algo = jsim.build_algorithm("dfedpgp", jloss, mask,
                                jsim.SimConfig(m=M))
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(jax.random.PRNGKey(3), M))
    jstate, jlayout = algo.init_flat(stacked)
    rng = np.random.default_rng(0)
    flat = (np.asarray(jstate.flat)
            + 0.1 * rng.standard_normal(jstate.flat.shape)
            ).astype(np.float32)
    mu = np.abs(1.0 + 0.3 * rng.standard_normal(M)).astype(np.float32)
    jstate = jstate._replace(flat=jnp.asarray(flat), mu=jnp.asarray(mu))
    tstate = convert.flat_state_from_reference(
        flat=flat, personal=_np(jstate.personal), mu=mu,
        mom_u=np.asarray(jstate.opt_u.momentum),
        mom_v=_np(jstate.opt_v.momentum), round=np.asarray(jstate.round))
    tlayout = FlatLayout.build(convert.params_from_reference(_np(stacked)),
                               _mask_t())
    uid = rng.integers(0, M, size=(B,)).astype(np.int32)
    x = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    return dict(jstate=jstate, jlayout=jlayout, tstate=tstate,
                tlayout=tlayout, uid=uid, x=x)


def _mask_t():
    p = tcnn.init_params(torch.Generator().manual_seed(0), CFG_T)
    return tpartition.build_mask(p, tpartition.classifier_personal)


def _assert_tree(t_tree, j_tree, rtol, atol):
    for path, leaf in tree.paths(t_tree):
        ref = j_tree
        for key in path:
            ref = ref[key]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref), rtol=rtol,
                                   atol=atol, err_msg="/".join(path))


@pytest.mark.parametrize("consensus", [2, "mass", "mean"])
def test_from_train_state_matches_reference(states, consensus):
    # anchor: one IEEE division per element on both sides -> exact.
    # mass / mean: f32 sums over the m clients in another order -> rtol 1e-6
    js = jserve.from_train_state(states["jstate"], layout=states["jlayout"],
                                 consensus=consensus)
    ts = tserve.from_train_state(states["tstate"], layout=states["tlayout"],
                                 consensus=consensus)
    tol = 0.0 if isinstance(consensus, int) else 1e-6
    _assert_tree(ts.trunk, _np(js.trunk), rtol=tol, atol=tol)
    _assert_tree(ts.personal, _np(js.personal), rtol=0, atol=0)
    assert ts.n_users() == M
    with pytest.raises(ValueError, match="consensus"):
        tserve.from_train_state(states["tstate"], layout=states["tlayout"],
                                consensus="median")


def _tree_states(states):
    """The fixture's resident state in tree form, in both engines: the
    stacked params unraveled through each engine's own layout."""
    from repro.core import dfedpgp as jdfedpgp
    from repro.core import gossip as jgossip
    from repro_torch.core import dfedpgp as tdfedpgp
    from repro_torch.core import gossip as tgossip
    js, ts = states["jstate"], states["tstate"]
    jparams = jgossip.FlatClientState(js.flat, js.personal).to_tree(
        states["jlayout"])
    tparams = tgossip.FlatClientState(ts.flat, ts.personal).to_tree(
        states["tlayout"])
    jtree = jdfedpgp.DFedPGPState(jparams, js.mu, js.opt_u, js.opt_v,
                                  js.round)
    ttree = tdfedpgp.DFedPGPState(tparams, ts.mu, ts.opt_u, ts.opt_v,
                                  ts.round)
    jmask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                   CFG_J),
                                  jpartition.classifier_personal)
    return jtree, ttree, jmask


@pytest.mark.parametrize("consensus", [2, "mass", "mean"])
def test_from_train_state_tree_form_matches_flat_and_reference(states,
                                                               consensus):
    # the tree form packs through the same wire layout as the resident
    # buffer: bitwise the flat form's ServingState; against the reference's
    # tree form the flat form's tolerance (exact anchor, rtol 1e-6 sums)
    jtree, ttree, jmask = _tree_states(states)
    flat = tserve.from_train_state(states["tstate"], layout=states["tlayout"],
                                   consensus=consensus)
    got = tserve.from_train_state(ttree, mask=_mask_t(), consensus=consensus)
    for (path, a), (_, b) in zip(tree.paths(got.trunk),
                                 tree.paths(flat.trunk)):
        assert torch.equal(a, b), "/".join(path)
    for (path, a), (_, b) in zip(tree.paths(got.personal),
                                 tree.paths(flat.personal)):
        assert torch.equal(a, b), "/".join(path)
    want = jserve.from_train_state(jtree, mask=jmask, consensus=consensus)
    tol = 0.0 if isinstance(consensus, int) else 1e-6
    _assert_tree(got.trunk, _np(want.trunk), rtol=tol, atol=tol)
    _assert_tree(got.personal, _np(want.personal), rtol=0, atol=0)
    assert got.n_users() == M


def test_from_train_state_refuses_what_the_reference_refuses(states):
    _, ttree, _ = _tree_states(states)
    with pytest.raises(ValueError, match="mask"):
        tserve.from_train_state(ttree)
    with pytest.raises(ValueError, match="FlatLayout"):
        tserve.from_train_state(states["tstate"])
    with pytest.raises(TypeError, match="DFedPGPState"):
        tserve.from_train_state(ttree.params, mask=_mask_t())
    with pytest.raises(TypeError, match="DFedPGPState"):
        jserve.from_train_state(ttree.params, mask=_mask_t())


def test_serve_logits_matches_reference(states):
    # trunk convs and GroupNorm summed in another order (XLA:CPU vs oneDNN)
    # before the f32 head: rtol/atol 2e-5
    js = jserve.from_train_state(states["jstate"], layout=states["jlayout"])
    ts = tserve.from_train_state(states["tstate"], layout=states["tlayout"])
    want = jax.jit(lambda u, x: jserve.serve_logits(js, u, x, CFG_J,
                                                    force="ref"))(
        jnp.asarray(states["uid"]), jnp.asarray(states["x"]))
    uid, x = torch.as_tensor(states["uid"]), torch.as_tensor(states["x"])
    got = tserve.serve_logits(ts, uid, x, CFG_T)
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    server = tserve.make_cnn_server(ts, CFG_T, device="cpu")
    assert torch.equal(server(uid, x), got.detach())


def test_serve_naive_agrees_with_fused_and_reference(states):
    # the naive path runs one forward per request (batch of 1) while the
    # fused path batches the trunk: same math, other summation order ->
    # rtol/atol 2e-5, both against each other and against the reference
    js = jserve.from_train_state(states["jstate"], layout=states["jlayout"])
    ts = tserve.from_train_state(states["tstate"], layout=states["tlayout"])
    models_t = tree.tree_map(lambda *a: torch.stack(a),
                             *[ts.user_model(i) for i in range(M)])
    models_j = jax.tree.map(lambda *a: jnp.stack(a),
                            *[js.user_model(i) for i in range(M)])
    uid, x = torch.as_tensor(states["uid"]), torch.as_tensor(states["x"])
    naive_t = tserve.serve_naive(models_t, uid, x, CFG_T)
    fused_t = tserve.serve_logits(ts, uid, x, CFG_T).detach()
    naive_j = jax.jit(lambda u, xx: jserve.serve_naive(models_j, u, xx,
                                                       CFG_J))(
        jnp.asarray(states["uid"]), jnp.asarray(states["x"]))
    np.testing.assert_allclose(naive_t.numpy(), fused_t.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(naive_t.numpy(), np.asarray(naive_j),
                               rtol=2e-5, atol=2e-5)
