"""Regime B of the port against the reference's: the same init, neighbor
tables and token batches (drawn on the JAX side) go through the
reference's `launch.steps.build_train_algo(cfg, None, layout, spec=...)`
rounds, jitted on one CPU device, and the port's, at reduced()
qwen2-0.5b with m 4 clients and f32 compute.

Measured with jax 0.9.0 and torch 2.13 on the CPU (max |diff| over every
state leaf, the momentum's in each case): 3 resident rounds 1.4e-6, 2
tree-form rounds 1.1e-6, 2 sampled rounds 1.0e-6, one round at S 2,048
through `block_attention` 2.3e-7, recurrentgemma-9b's round through the
plain scan 7.9e-6; mu exact everywhere.  The tolerance is rtol 1e-4,
atol 2e-5 per leaf (as the CNN rounds of tests/test_torch_dfedpgp.py).
bf16 compute is held to the repo's LM bf16 bound (max 0.25, relative L2
6%, tests/test_torch_hybrid.py) on the loss and on the buffer's update
(measured: loss 9.5e-4 apart, the update (up to 0.36) 1.2e-4 apart at
most, relative L2 7.1e-5).  That bound is wider than any update at lr
0.02, so the leg also holds the loss and the update to 10x the measured
gaps (1e-2, 1.2e-3), limits that a real fault would cross."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import topology as jtopology
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.spec import make_algo_spec as jmake_spec
from repro_torch import convert, tree
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.core import topology as ttopology
from repro_torch.launch import steps as tsteps
from repro_torch.models import hybrid as thybrid
from repro_torch.spec import make_algo_spec as tmake_spec

torch.set_num_threads(2)
M, B, S = 4, 2, 32
ARCH = "qwen2-0.5b"
RTOL, ATOL = 1e-4, 2e-5
BF16 = dict(max_abs=0.25, rel_l2=0.06)
BF16_MEASURED_X10 = dict(loss=1e-2, update=1.2e-3)
SPEC_KW = dict(topology="random", n_neighbors=2, seed=0, gossip="matrix")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(arch, **replace):
    return (jget_reduced(arch).replace(**replace),
            tget_reduced(arch).replace(**replace))


def _algos(arch, cdtype="float32", bf16_grads=False, **spec_kw):
    """Both packages' build_train_algo on one device from equal specs."""
    cfg_j, cfg_t = _cfgs(arch, compute_dtype=cdtype)
    kw = dict(SPEC_KW, **spec_kw)
    lay_j = jsteps.Layout(("data",), (), ("model",), (), M, B)
    lay_t = tsteps.Layout(("data",), (), ("model",), (), M, B)
    jalgo = jsteps.build_train_algo(cfg_j, None, lay_j, lr=0.02,
                                    bf16_grads=bf16_grads,
                                    spec=jmake_spec("dfedpgp", **kw))
    talgo = tsteps.build_train_algo(cfg_t, None, lay_t, lr=0.02,
                                    bf16_grads=bf16_grads,
                                    spec=tmake_spec("dfedpgp", **kw))
    return cfg_j, cfg_t, jalgo, talgo


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    """The reference's stacked init of m clients (train.py's key layout)."""
    cfg_j, _ = _cfgs(arch)
    api = jget_model(cfg_j)
    return jax.vmap(lambda k: api.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(0), M))


def _tables(kind, t, active=None):
    """Round t's reference table (induced on `active`), both forms."""
    P = jtopology.get_schedule(kind, M, SPEC_KW["n_neighbors"],
                               SPEC_KW["seed"]).at(t)
    if active is not None:
        P = jtopology.induced_subgraph(P, jnp.asarray(active), "row")
    return P, ttopology.SparseTopology(torch.tensor(np.asarray(P.idx)),
                                       torch.tensor(np.asarray(P.w)))


def _batches(vocab, n, seq, batch, seed):
    """{'v', 'u'} token batches (n, 1, batch, seq) with shifted labels."""
    rng = np.random.default_rng(seed)
    toks = {k: rng.integers(0, vocab, size=(n, 1, batch, seq)).astype(
        np.int32) for k in "vu"}
    bj = {k: {"tokens": jnp.asarray(t), "labels": jnp.asarray(
        np.roll(t, -1, -1))} for k, t in toks.items()}
    bt = {k: {"tokens": torch.as_tensor(t).long(), "labels": torch.as_tensor(
        np.roll(t, -1, -1)).long()} for k, t in toks.items()}
    return bj, bt


def _flat_from_reference(sj):
    return convert.flat_state_from_reference(
        flat=np.asarray(sj.flat), personal=jax.tree.map(np.asarray,
                                                        sj.personal),
        mu=np.asarray(sj.mu), mom_u=np.asarray(sj.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, sj.opt_v.momentum),
        round=np.asarray(sj.round))


def _tree_from_reference(sj):
    return convert.tree_state_from_reference(
        params=jax.tree.map(np.asarray, sj.params), mu=np.asarray(sj.mu),
        mom_u=jax.tree.map(np.asarray, sj.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, sj.opt_v.momentum),
        round=np.asarray(sj.round))


def _leaves(state):
    """{name: array} over a state's tensor leaves (trees flattened)."""
    out = {}
    for field, val in state._asdict().items():
        if hasattr(val, "_asdict"):
            val = val._asdict()
        if isinstance(val, dict):
            for p, leaf in tree.paths(val):
                if leaf is not None:
                    out[field + "/" + "/".join(p)] = leaf
        elif val is not None:
            out[field] = val
    return out


def _hold(tstate, jstate, rtol=RTOL, atol=ATOL) -> float:
    """Every tensor leaf of the port's state against the reference's;
    mu exact.  -> the largest |diff|."""
    got = {k: v.detach().double().numpy() for k, v in _leaves(tstate).items()}
    want = {k: np.asarray(v, np.float64)
            for k, v in _leaves(jstate).items()
            if k in got or np.ndim(v) > 1}
    assert set(got) == set(want), (set(got) ^ set(want))
    worst = 0.0
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
        worst = max(worst, float(np.abs(got[k] - want[k]).max()))
    np.testing.assert_array_equal(tstate.mu.numpy(), np.asarray(jstate.mu))
    return worst


def _run_flat(arch, rounds, seq=S, batch=B, cdtype="float32", **kw):
    """`rounds` resident rounds on both sides -> (port, reference)
    states, both last rounds' metrics, and the initial buffer."""
    cfg_j, cfg_t, (ja, _, _, jfl), (ta, _, _, tfl) = _algos(
        arch, cdtype, resident=True, **kw)
    sj, jfl = ja.init_flat(_reference_init(arch), jfl)
    st = _flat_from_reference(sj)
    flat0 = np.asarray(sj.flat, np.float64)
    step = jax.jit(lambda s, P, b: ja.round_fn_flat(s, P, b, jfl))
    for r in range(rounds):
        Pj, Pt = _tables("random", r)
        bj, bt = _batches(cfg_t.vocab, M, seq, batch, seed=r)
        sj, mj = step(sj, Pj, bj)
        st, mt = ta.round_fn_flat(st, Pt, bt, tfl)
    return st, sj, mt, mj, flat0


def test_resident_rounds_match_reference():
    st, sj, mt, mj, _ = _run_flat(ARCH, 3)
    assert _hold(st, sj) < 1e-5
    np.testing.assert_allclose(mt["loss_u"].item(), float(mj["loss_u"]),
                               rtol=1e-5)


def test_tree_form_rounds_match_reference():
    cfg_j, cfg_t, (ja, *_), (ta, *_) = _algos(ARCH, resident=False)
    sj = ja.init(_reference_init(ARCH))
    st = _tree_from_reference(sj)
    step = jax.jit(ja.round_fn)
    for r in range(2):
        Pj, Pt = _tables("random", r)
        bj, bt = _batches(cfg_t.vocab, M, S, B, seed=10 + r)
        sj, _ = step(sj, Pj, bj)
        st, _ = ta.round_fn(st, Pt, bt)
    assert _hold(st, sj) < 1e-5


def test_sampled_rounds_match_reference():
    # frac 0.5: 2 of 4 clients a round, the reference's sampler's ids
    # (the port's ParticipationSampler replays them id for id)
    kw = dict(resident=True, participation="uniform", participation_frac=0.5)
    cfg_j, cfg_t, (ja, _, _, jfl), (ta, _, _, tfl) = _algos(ARCH, **kw)
    sampler = tmake_spec("dfedpgp", **SPEC_KW, **kw).sampler(M)
    sj, jfl = ja.init_flat(_reference_init(ARCH), jfl)
    st = _flat_from_reference(sj)
    step = jax.jit(lambda s, P, a, b: ja.round_fn_sampled(s, P, a, b, jfl))
    for r in range(2):
        active = sampler.active_at(r)
        assert len(active) == 2
        Pj, Pt = _tables("random", r, active)
        bj, bt = _batches(cfg_t.vocab, 2, S, B, seed=20 + r)
        before = st.flat.clone()
        sj, mj = step(sj, Pj, jnp.asarray(active), bj)
        st, mt = ta.round_fn_sampled(st, Pt, torch.as_tensor(active), bt,
                                     tfl)
        dormant = np.setdiff1d(np.arange(M), active)
        assert torch.equal(st.flat[dormant], before[dormant])
        assert mt["n_active"] == 2
    assert _hold(st, sj) < 1e-5


def test_bf16_grads_hooks_scoped_to_shared_mask():
    # the reference's tests/test_steps_lowering.py:131-152 on the port: the
    # tree hook narrows only the shared leaves with dims, the row hook the
    # whole (d_flat,) row
    _, cfg_t, (ja, jmask, jstruct, _), (ta, tmask, tstruct, _) = _algos(
        ARCH, bf16_grads=True, resident=False)
    grads = tree.tree_map(lambda x: torch.zeros(x.shape[1:], dtype=x.dtype),
                          tstruct)
    out = ta.grad_hook(grads)
    n_personal = 0
    for (path, g), (_, shared) in zip(tree.paths(out), tree.paths(tmask)):
        want = torch.bfloat16 if shared and g.dim() else torch.float32
        assert g.dtype == want, path
        n_personal += not shared
    assert n_personal == 2           # lm_head, final_norm
    assert ta.grad_hook_flat(torch.zeros(7)).dtype == torch.bfloat16
    # the same leaves narrow on both sides
    jout = ja.grad_hook(jax.tree.map(
        lambda x: jnp.zeros(x.shape[1:], x.dtype), jstruct))
    jdt = {tuple(k.key for k in p): str(x.dtype) for p, x in
           jax.tree_util.tree_flatten_with_path(jout)[0]}
    assert {p: str(g.dtype).split(".")[-1] for p, g in tree.paths(out)} \
        == jdt


def test_bf16_grads_round_matches_reference():
    # the row hook runs where the reference's does (on each client's
    # gradient row, before the optimizer).  The two f32 gradients differ
    # by ~1e-7, so where one lies at a bf16 rounding tie the two casts
    # round to neighbouring bf16 values: the momentum then differs by one
    # bf16 step of the gradient at those elements (measured: 396 of
    # 1,314,816 after 2 rounds, max 9.8e-4 = 2^-10, the step of gradients
    # in [2^-3, 2^-2)).  Those flips are counted and bounded; every other
    # element, the buffer and the personal leaves are held as the f32
    # rounds are
    st, sj, *_ = _run_flat(ARCH, 2, bf16_grads=True)
    got = st.opt_u.momentum.double().numpy()
    want = np.asarray(sj.opt_u.momentum, np.float64)
    off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert off.mean() <= 1e-3, off.sum()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    _hold(st._replace(opt_u=sj.opt_u.__class__(
        torch.as_tensor(np.where(off, want, got)))), sj)


def test_block_attention_round_at_2048():
    # S 2,048 = BLOCK_ATTN_MIN_SEQ: both sides train through
    # block_attention (two query blocks of 1,024)
    from repro_torch.models import layers as TL
    assert S < TL.BLOCK_ATTN_MIN_SEQ == 2048
    st, sj, mt, mj, _ = _run_flat(ARCH, 1, seq=2048, batch=1)
    assert _hold(st, sj) < 1e-5
    np.testing.assert_allclose(mt["loss_u"].item(), float(mj["loss_u"]),
                               rtol=1e-5)


def test_bf16_compute_round_within_the_lm_bound():
    # bf16 compute: XLA fuses f32 elementwise chains that torch rounds op
    # by op (ROADMAP queue 3, "bf16 LM gap"), so the round is held to the
    # repo's LM bf16 bound on the loss and on the buffer's update
    st, sj, mt, mj, flat0 = _run_flat(ARCH, 1, cdtype="bfloat16")
    loss_gap = abs(mt["loss_u"].item() - float(mj["loss_u"]))
    assert loss_gap <= BF16["max_abs"]
    assert loss_gap <= BF16_MEASURED_X10["loss"], loss_gap
    got = st.flat.double().numpy() - flat0
    want = np.asarray(sj.flat, np.float64) - flat0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    gap = np.abs(got - want).max()
    assert gap <= BF16["max_abs"]
    assert gap <= BF16_MEASURED_X10["update"], gap
    assert rel <= BF16["rel_l2"], rel
    np.testing.assert_array_equal(st.mu.numpy(), np.asarray(sj.mu))


def test_hybrid_resident_round_through_the_plain_scan():
    # recurrentgemma-9b reduced(): the RG-LRU trains through the port's
    # associative_scan, local attention through the plain route
    st, sj, mt, mj, _ = _run_flat("recurrentgemma-9b", 1)
    assert _hold(st, sj) < 1e-4
    np.testing.assert_allclose(mt["loss_u"].item(), float(mj["loss_u"]),
                               rtol=1e-5)


@pytest.mark.parametrize("seq", [1, 2, 3, 5, 8, 13, 64, 100, 128])
def test_associative_scan_rounding_against_reference(seq):
    # the port's scan makes the reference's combines in its order, each
    # product and sum rounded on its own; XLA:CPU contracts a2 * b1 + b2
    # into one FMA rounding, so results part by a few ulps.  Measured
    # (values of |h| up to ~10): 0 at S 1, <= 2.4e-7 at S 2-5, 4.8e-7 at
    # 8-13, <= 9.6e-7 at 64-128; bound 4 ulps of |h|'s scale plus 1e-7
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.8, 1.0, (2, seq, 16)).astype(np.float32)
    b = rng.standard_normal((2, seq, 16)).astype(np.float32)

    def combine(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return a1 * a2, a2 * b1 + b2

    want = np.asarray(jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1)[1])(a, b))
    got = thybrid.associative_scan(
        thybrid._linear_combine, [torch.tensor(a), torch.tensor(b)], 1)[1]
    err = np.abs(got.numpy() - want)
    scale = np.abs(want).max()
    assert err.max() <= 4 * np.spacing(np.float32(scale)) + 1e-7
    if seq == 1:
        assert err.max() == 0
    # and both are the sequential recurrence up to the same rounding
    h, seqv = np.zeros((2, 16), np.float32), []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        seqv.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seqv, 1), rtol=0,
                               atol=8 * np.spacing(np.float32(scale)))
