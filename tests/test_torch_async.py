"""Port parity of the async heterogeneity runtime's modules: profile
availability and the virtual clock, the push form of a table and its stale
discount, the push-sum primitives, the edge-gated mix, the mailbox, and
`AsyncRuntime.tick` — each against the JAX reference (`repro.hetero`,
`repro.core.topology`, `repro.core.pushsum`, `repro.core.gossip`) on the
same numpy inputs; then the port's own contracts: the uniform zero-delay
ticks are bit for bit `round_fn_flat`, and push-sum mass is conserved at
every tick under a random delay trace.

The fires' CUDA kernels (gossip_gather, topk_gather) run only on a GPU;
`chip_smoke.py` holds the async runs on the card against their plain
versions there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfedpgp as jdfedpgp
from repro.core import gossip as jgossip
from repro.core import partition as jpartition
from repro.core import pushsum as jpushsum
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.hetero import clock as jclock
from repro.hetero import mailbox as jmbox
from repro.hetero import profiles as jprofiles
from repro.hetero.runtime import AsyncRuntime as JAsyncRuntime
from repro.models import cnn as jcnn
from repro.optim import SGD as JSGD
from repro_torch import convert, tree
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import gossip as tgossip
from repro_torch.core import partition as tpartition
from repro_torch.core import pushsum as tpushsum
from repro_torch.core import topology as ttopology
from repro_torch.core.topology import SparseTopology
from repro_torch.hetero import clock as tclock
from repro_torch.hetero import mailbox as tmbox
from repro_torch.hetero import profiles as tprofiles
from repro_torch.hetero.runtime import AsyncRuntime
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGD as TSGD

torch.set_num_threads(2)
# a small CNN: two narrow conv layers, d_flat 1,620 shared
CFG_J = jcnn.CNNConfig(widths=(4, 8), d_feature=16, gn_groups=2)
CFG_T = tcnn.CNNConfig(widths=(4, 8), d_feature=16, gn_groups=2)
# 12 ticks of the small CNN: the engines' conv / GroupNorm / matmul sums
# run in other orders (XLA:CPU vs oneDNN), carried through up to 12 SGD
# steps and the delayed fires.  Measured worst abs error over every state
# leaf: 5.7e-7 (7.7e-7 with the topk codec), on the momenta; tolerance
# rtol 1e-5, atol 1e-6.
RTOL, ATOL = 1e-5, 1e-6


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _topo(P):
    return SparseTopology(_t(P.idx), _t(P.w))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# profiles and the clock
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tiered", "lognormal"])
def test_available_matches_reference_bitwise(kind):
    jp = jprofiles.make_profile(kind, 12, spread=5.0, push_delay_max=2,
                                availability=0.7, seed=3)
    tp = tprofiles.make_profile(kind, 12, spread=5.0, push_delay_max=2,
                                availability=0.7, seed=3)
    for t in range(0, 90):
        want = np.asarray(jp.available(jnp.float32(t)))
        got = tp.available(t)
        assert got.dtype == torch.bool and got.shape == (12,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(t))
    # the device copy answers the same; a tensor t too
    dp = tp.to("cpu")
    assert all(isinstance(a, torch.Tensor) for a in dp)
    np.testing.assert_array_equal(dp.available(torch.tensor(7)).numpy(),
                                  np.asarray(jp.available(jnp.float32(7))))


def test_availability_windows_like_reference():
    p = tprofiles.uniform(4)._replace(
        avail_period=np.asarray([0.0, 10.0, 10.0, 10.0], np.float32),
        avail_duty=np.asarray([1.0, 0.5, 0.5, 0.5], np.float32),
        avail_phase=np.asarray([0.0, 0.0, 5.0, 0.0], np.float32))
    on = torch.stack([p.available(t) for t in range(10)]).numpy()
    assert on[:, 0].all()
    assert on[:5, 1].all() and not on[5:, 1].any()
    assert not on[:5, 2].any() and on[5:, 2].all()


@pytest.mark.parametrize("costs", [[1.0, 1.7], [1.0, 2.5, 3.3, 4.9]])
def test_clock_fractional_costs_match_reference_bitwise(costs):
    m = len(costs)
    jp = jprofiles.uniform(m)._replace(step_cost=jnp.asarray(costs,
                                                             jnp.float32))
    tp = tprofiles.uniform(m)._replace(step_cost=np.asarray(costs,
                                                            np.float32))
    jc, tc = jclock.init_clock(m), tclock.init_clock(m)
    acts = []
    for _ in range(40):
        ja, ta = jclock.active_mask(jc, jp), tclock.active_mask(tc, tp)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        jc, tc = jclock.advance(jc, ja, jp), tclock.advance(tc, ta, tp)
        np.testing.assert_array_equal(tc.next_time.numpy(),
                                      np.asarray(jc.next_time))
        assert tc.t == int(jc.t)
        acts.append(ta.numpy())
    acts = np.stack(acts)
    assert acts[:, 0].all()
    if costs[1] == 1.7:
        # 17 ticks of budget buy exactly 10 steps: next_time 0, 1.7, 3.4,
        # 5.1, 6.8, 8.5, ... is reached at ticks 0, 2, 4, 6, 7, 9, ...
        assert acts[:17, 1].sum() == 10
        assert list(np.nonzero(acts[:10, 1])[0]) == [0, 2, 4, 6, 7, 9]


# ---------------------------------------------------------------------------
# the push form and the stale discount
# ---------------------------------------------------------------------------
def _pull_tables():
    return {
        "random": jtopology.directed_random(jax.random.PRNGKey(0), 12, 4),
        "undirected": jtopology.undirected_random(jax.random.PRNGKey(1), 12,
                                                  3),
        "ring": jtopology.ring(8),
        "exponential": jtopology.directed_exponential(8, 3)}


@pytest.mark.parametrize("kind", ["random", "undirected", "ring",
                                  "exponential"])
@pytest.mark.parametrize("per_sender", [False, True])
def test_to_push_sparse_matches_reference(kind, per_sender):
    P = _pull_tables()[kind]
    m = P.idx.shape[0]
    sw = np.linspace(0.5, 0.9, m).astype(np.float32) if per_sender \
        else 0.5
    want = jtopology.to_push_sparse(P, self_weight=sw)
    got = ttopology.to_push_sparse(_topo(P), self_weight=sw)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               rtol=1e-6, atol=1e-6)
    D = got.dense().numpy()
    np.testing.assert_allclose(D.sum(0), 1.0, atol=1e-5)
    np.testing.assert_allclose(D.diagonal(), sw if per_sender
                               else np.full(m, 0.5), atol=1e-6)


def test_to_push_sparse_rejections_match_reference():
    P = _pull_tables()["random"]
    for sw in (1.0, np.full((12,), -0.1, np.float32)):
        with pytest.raises(ValueError, match="self_weight"):
            jtopology.to_push_sparse(P, self_weight=sw)
        with pytest.raises(ValueError, match="self_weight"):
            ttopology.to_push_sparse(_topo(P), self_weight=sw)
    # a row without a self entry would destroy the kept share
    idx = np.asarray(P.idx).copy()
    idx[3, 0] = 5
    bad = jtopology.SparseTopology(jnp.asarray(idx), P.w)
    with pytest.raises(ValueError, match="self entry"):
        jtopology.to_push_sparse(bad)
    with pytest.raises(ValueError, match="self entry"):
        ttopology.to_push_sparse(_topo(bad))


def test_staleness_self_weight_matches_reference():
    d = np.asarray([0, 1, 3, 7], np.int32)
    want = np.asarray(jtopology.staleness_self_weight(jnp.asarray(d),
                                                      base=0.5))
    got = ttopology.staleness_self_weight(d, base=0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), [0.5, 0.75, 0.875, 0.9375])
    assert got.dtype == torch.float32


# ---------------------------------------------------------------------------
# push-sum primitives
# ---------------------------------------------------------------------------
def test_pushsum_functions_match_reference():
    rng = np.random.default_rng(0)
    m = 6
    u = {"a": rng.standard_normal((m, 3, 2)).astype(np.float32),
         "b": rng.standard_normal((m,)).astype(np.float32)}
    mu = rng.uniform(0.5, 1.5, m).astype(np.float32)
    P = jtopology.to_push_sparse(jtopology.directed_random(
        jax.random.PRNGKey(3), m, 2))
    js = jpushsum.PushSumState(jax.tree.map(jnp.asarray, u), jnp.asarray(mu))
    ts = tpushsum.PushSumState(tree.tree_map(_t, u), _t(mu))

    def close(t_tree, j_tree):
        for path, leaf in tree.paths(t_tree):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(
                tree.get(j_tree, path)), rtol=1e-6, atol=1e-6)

    init_j = jpushsum.init_state(js.u)
    init_t = tpushsum.init_state(ts.u)
    np.testing.assert_array_equal(init_t.mu.numpy(), np.asarray(init_j.mu))
    mixed_j, mixed_t = jpushsum.mix(P, js), tpushsum.mix(_topo(P), ts)
    close(mixed_t.u, mixed_j.u)
    np.testing.assert_allclose(mixed_t.mu.numpy(), np.asarray(mixed_j.mu),
                               rtol=1e-6)
    close(tpushsum.debias(ts), jpushsum.debias(js))
    close(tpushsum.rebias(ts.u, ts.mu), jpushsum.rebias(js.u, js.mu))
    close(tpushsum.consensus(ts), jpushsum.consensus(js))
    np.testing.assert_allclose(float(tpushsum.consensus_distance(ts)),
                               float(jpushsum.consensus_distance(js)),
                               rtol=1e-6)
    flat = rng.standard_normal((m, 5)).astype(np.float32)
    mail_f = rng.standard_normal((m, 5)).astype(np.float32)
    mail_mu = rng.uniform(0.0, 0.5, m).astype(np.float32)
    zj, ej = jpushsum.debias_in_flight(jnp.asarray(flat), jnp.asarray(mu),
                                       jnp.asarray(mail_f),
                                       jnp.asarray(mail_mu))
    zt, et = tpushsum.debias_in_flight(_t(flat), _t(mu), _t(mail_f),
                                       _t(mail_mu))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(
        float(tpushsum.total_mass(_t(mu), _t(mail_mu), _t(mail_mu))),
        float(jpushsum.total_mass(jnp.asarray(mu), jnp.asarray(mail_mu),
                                  jnp.asarray(mail_mu))), rtol=1e-6)
    act = np.asarray([True, False] * 3)
    for a, b in zip(tpushsum.mass_split(_t(mu), act, _t(mail_mu)),
                    jpushsum.mass_split(jnp.asarray(mu), act,
                                        jnp.asarray(mail_mu))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# the edge-gated mix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sparse", "pallas"])
def test_mix_flat_edge_gate_matches_reference(mode):
    rng = np.random.default_rng(1)
    m, d = 10, 33
    P = jtopology.to_push_sparse(jtopology.directed_random(
        jax.random.PRNGKey(5), m, 3))
    flat = rng.standard_normal((m, d)).astype(np.float32)
    mu = rng.uniform(0.5, 1.5, m).astype(np.float32)
    gate = rng.integers(0, 2, P.idx.shape).astype(np.float32)
    gate[2] = 0.0                      # a row gated off whole: +0.0 rows
    jf, jmu = jgossip.mix_flat(P, jnp.asarray(flat), jnp.asarray(mu),
                               mode="sparse", edge_gate=jnp.asarray(gate))
    tf, tmu = tgossip.mix_flat(_topo(P), _t(flat), _t(mu), mode=mode,
                               edge_gate=_t(gate))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-6)
    # bit for bit the port's mix_rows on the gated table, and nothing is
    # renormalized: the gated row sums are the ungated ones times the gate
    wg = _t(np.asarray(P.w)) * _t(gate)
    assert torch.equal(tf, tgossip.mix_rows(_t(P.idx), wg, _t(flat)))
    assert torch.equal(tmu, tgossip.mix_rows(_t(P.idx), wg, _t(mu)))
    assert torch.equal(tf[2], torch.zeros(d)) and float(tmu[2]) == 0.0


def test_mix_flat_edge_gate_rejects_dense_like_reference():
    P = jtopology.directed_random(jax.random.PRNGKey(5), 6, 2)
    gate = np.ones(P.idx.shape, np.float32)
    with pytest.raises(ValueError, match="SparseTopology"):
        jgossip.mix_flat(P.dense(), jnp.ones((6, 3)), jnp.ones((6,)),
                         edge_gate=jnp.asarray(gate))
    with pytest.raises(ValueError, match="SparseTopology"):
        tgossip.mix_flat(_topo(P).dense(), torch.ones((6, 3)),
                         torch.ones((6,)), edge_gate=_t(gate))


# ---------------------------------------------------------------------------
# the mailbox
# ---------------------------------------------------------------------------
def test_mailbox_delivery_timing_and_sleeping_receiver():
    m, d = 4, 3
    P = ttopology.ring(m)
    mail = tmbox.create(m, d, depth=3)
    flat, mu = torch.ones((m, d)), torch.ones((m,))
    fired = torch.ones((m,), dtype=torch.bool)
    delay = torch.tensor([[0, 2]] * m, dtype=torch.int32)
    before = mail
    mail = tmbox.push(mail, P, flat, mu, fired, delay, tick=0)
    assert float(before.slots_mu.sum()) == 0.0       # inputs never written
    assert float(mail.inbox_mu.sum()) == 0.0
    mail = tmbox.flush(mail, 1)                      # delay 0: tick 1
    np.testing.assert_allclose(mail.inbox_mu.numpy(), 0.5)
    mail = tmbox.flush(mail, 2)
    np.testing.assert_allclose(mail.inbox_mu.numpy(), 0.5)
    mail = tmbox.flush(mail, 3)                      # delay 2: tick 3
    np.testing.assert_allclose(mail.inbox_mu.numpy(), 1.0)
    for t in range(4, 9):                            # a sleeping receiver
        mail = tmbox.flush(mail, t)
    np.testing.assert_allclose(mail.inbox_mu.numpy(), 1.0)
    mail, got_f, got_mu = tmbox.drain(mail, torch.tensor([True, False] * 2))
    np.testing.assert_allclose(got_mu.numpy(), [1.0, 0.0, 1.0, 0.0])
    np.testing.assert_allclose(mail.inbox_mu.numpy(), [0.0, 1.0, 0.0, 1.0])
    np.testing.assert_allclose(got_f.numpy()[0], 1.0)
    np.testing.assert_allclose(float(tmbox.mass(mail) + got_mu.sum()), m,
                               rtol=1e-6)


def test_mailbox_push_flush_in_flight_match_reference():
    rng = np.random.default_rng(2)
    m, d, depth = 8, 7, 3
    Pj = jtopology.to_push_sparse(jtopology.directed_random(
        jax.random.PRNGKey(9), m, 3))
    jm, tm = jmbox.create(m, d, depth), tmbox.create(m, d, depth)
    for t in range(7):
        flat = rng.standard_normal((m, d)).astype(np.float32)
        mu = rng.uniform(0.1, 1.0, m).astype(np.float32)
        fired = rng.random(m) < 0.6
        delay = rng.integers(0, depth, Pj.idx.shape).astype(np.int32)
        jm, tm = jmbox.flush(jm, t), tmbox.flush(tm, t)
        jm = jmbox.push(jm, Pj, jnp.asarray(flat), jnp.asarray(mu),
                        jnp.asarray(fired), jnp.asarray(delay), t)
        tm = tmbox.push(tm, _topo(Pj), _t(flat), _t(mu), _t(fired),
                        _t(delay), t)
        who = rng.random(m) < 0.5
        jm, jgf, jgm = jmbox.drain(jm, jnp.asarray(who))
        tm, tgf, tgm = tmbox.drain(tm, _t(who))
        for a, b in zip(tm + (tgf, tgm), jm + (jgf, jgm)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    for a, b in zip(tmbox.in_flight(tm), jmbox.in_flight(jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(float(tmbox.mass(tm)), float(jmbox.mass(jm)),
                               rtol=1e-6)


def test_mailbox_depth_guards():
    with pytest.raises(ValueError, match="depth"):
        tmbox.create(4, 3, depth=0)
    mail = tmbox.create(4, 3, depth=2)
    args = (torch.ones((4, 3)), torch.ones((4,)),
            torch.ones((4,), dtype=torch.bool),
            torch.zeros((4, 4), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="SparseTopology"):
        tmbox.push(mail, torch.eye(4), *args)
    with pytest.raises(ValueError, match="n_groups"):
        tmbox.push(mail, ttopology.ring(4), *args[:2], args[2],
                   torch.zeros((4, 2), dtype=torch.int32), 0, n_groups=3)


# ---------------------------------------------------------------------------
# AsyncRuntime.tick against the reference's jitted tick
# ---------------------------------------------------------------------------
def _cnn_pair(m, seed=0):
    """The reference's data and stacked init for the small CNN, and both
    engines' DFedPGP on them."""
    key = jax.random.PRNGKey(seed)
    data = jmake_dataset(key, m, n_train=16, n_test=8)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(jax.random.fold_in(key, 1), m))
    jmask = jpartition.build_mask(jcnn.init_params(key, CFG_J),
                                  jpartition.classifier_personal)
    tstacked = convert.params_from_reference(jax.tree.map(np.asarray,
                                                          stacked))
    tmask = tpartition.build_mask(tstacked, tpartition.classifier_personal)
    return data, stacked, jmask, tstacked, tmask


def _algos(jmask, tmask, **kw):
    jopt = JSGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    topt = TSGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    common = dict(k_v=1, k_u=2, lr_decay=0.99)
    common.update(kw)
    ja = jdfedpgp.DFedPGP(
        loss_fn=lambda p, b: jcnn.loss_fn(p, b, CFG_J), mask=jmask,
        opt_u=jopt, opt_v=jopt, **common)
    ta = tdfedpgp.DFedPGP(
        loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T), mask=tmask,
        opt_u=topt, opt_v=topt, **common)
    return ja, ta


def _leaves(state):
    """(name, numpy) for every array of an async state, either engine."""
    out = {}

    def walk(x, prefix):
        if x is None:
            return
        if hasattr(x, "_fields"):
            for name, val in zip(x._fields, x):
                walk(val, f"{prefix}{name}/")
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}{k}/")
        else:
            out[prefix.rstrip("/")] = _np(x)
    walk(state, "")
    return out


def _hold_states(ts, js):
    a, b = _leaves(ts), _leaves(js)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].astype(np.float64),
                                   b[k].astype(np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


METRICS = ("loss", "n_active", "n_fired", "wire_edges", "mass_total",
           "vtime")


@pytest.mark.parametrize("codec", [None, "topk"])
def test_tick_matches_reference_jitted_tick(codec):
    """12 ticks, tiered speeds, push delays up to 2, duty 0.7: every state
    leaf (mailbox included) and the six metrics against the reference."""
    m = 8
    data, stacked, jmask, tstacked, tmask = _cnn_pair(m)
    kw = {}
    if codec is not None:
        from repro import compress as jcompress
        from repro_torch import compress as tcompress
        kw = dict(codec_gamma=0.5)
        ja, ta = _algos(jmask, tmask, codec=jcompress.make_codec(
            "topk", ratio=1 / 16), **kw)
        ta = dataclasses.replace(ta, codec=tcompress.make_codec(
            "topk", ratio=1 / 16))
    else:
        ja, ta = _algos(jmask, tmask)
    jprof = jprofiles.tiered(m, spread=3.0, push_delay_max=2,
                             availability=0.7, seed=1)
    tprof = tprofiles.tiered(m, spread=3.0, push_delay_max=2,
                             availability=0.7, seed=1)
    jrt, js = JAsyncRuntime.build(ja, stacked, jprof, depth=3)
    trt, ts = AsyncRuntime.build(ta, tstacked, tprof, depth=3,
                                 device="cpu")
    assert trt.profile_groups == jrt.profile_groups == 3
    jtick = jax.jit(lambda s, p, b: jrt.tick(s, p, b))
    fired_any = 0
    for t in range(12):
        b = jsample_batches(jax.random.fold_in(jax.random.PRNGKey(7), t),
                            data, 1, 8)
        b = jax.tree.map(lambda a: a[:, 0], b)
        P = jtopology.to_push_sparse(jtopology.directed_random(
            jax.random.PRNGKey(100 + t), m, 3))
        js, jm = jtick(js, P, b)
        ts, tm = trt.tick(ts, _topo(P), {"x": _t(b["x"]),
                                         "y": _t(b["y"], torch.int64)})
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        fired_any += int(tm["n_fired"] > 0)
        _hold_states(ts, js)
    assert fired_any >= 3 and int(ts.local_round.max()) >= 2
    # eval mid-flight, counting the mailbox mass
    ev_t, ev_j = trt.eval_params(ts), jrt.eval_params(js)
    for path, leaf in tree.paths(ev_t):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(
            tree.get(ev_j, path)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(trt.mass_total(ts)), m, rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k_v,k_u", [(1, 2), (2, 3), (0, 3)])
def test_uniform_zero_delay_ticks_are_round_fn_flat_bitwise(k_v, k_u):
    """Under the uniform profile every client fires together every
    k_v + k_u ticks: after flushing and draining the last fire, flat, mu,
    the personal leaves and both momenta equal round_fn_flat's bit for
    bit (k_v = 0: the all-shared cores of async OSGP / DFedAvgM)."""
    m = 8
    data, stacked, jmask, tstacked, tmask = _cnn_pair(m, seed=3)
    if k_v == 0:
        tmask = tree.tree_map(lambda _: True, tmask)
    _, algo = _algos(jmask, tmask, k_v=k_v, k_u=k_u)
    s_sync, layout = algo.init_flat(tstacked, device="cpu")
    rt, s_async = AsyncRuntime.build(algo, tstacked, tprofiles.uniform(m),
                                     depth=2, device="cpu")
    k_total = rt.k_total
    for r in range(3):
        P = ttopology.get_schedule("random", m, 3, 13).at(r)
        b = jsample_batches(jax.random.fold_in(jax.random.PRNGKey(4), r),
                            data, k_total, 8)
        b = {"x": _t(b["x"]), "y": _t(b["y"], torch.int64)}
        s_sync, _ = algo.round_fn_flat(
            s_sync, P, {"v": {k: a[:, :k_v] for k, a in b.items()},
                        "u": {k: a[:, k_v:] for k, a in b.items()}}, layout)
        for t in range(k_total):
            s_async, mt = rt.tick(s_async, P,
                                  {k: a[:, t] for k, a in b.items()})
            assert int(mt["n_fired"]) == (m if t == k_total - 1 else 0)
            assert int(mt["n_active"]) == m
    mail = tmbox.flush(s_async.mail, s_async.clock.t)
    mail, got_f, got_mu = tmbox.drain(mail, torch.ones(m, dtype=torch.bool))
    assert torch.equal(s_async.flat + got_f, s_sync.flat)
    assert torch.equal(s_async.mu + got_mu, s_sync.mu)
    assert torch.equal(s_async.opt_u.momentum, s_sync.opt_u.momentum)
    for path, leaf in tree.paths(s_sync.personal):
        assert torch.equal(tree.get(s_async.personal, path), leaf), path
    for path, leaf in tree.paths(s_sync.opt_v.momentum):
        assert torch.equal(tree.get(s_async.opt_v.momentum, path), leaf)
    assert (s_async.local_round == 3).all()
    # eval mid-flight (counting the mailbox mass) equals the sync eval
    ev_a = rt.eval_params(s_async)
    ev_s = algo.eval_params_flat(s_sync, layout)
    for path, leaf in tree.paths(ev_s):
        torch.testing.assert_close(tree.get(ev_a, path), leaf, rtol=0,
                                   atol=1e-6)


def _quad(m=10, d=6, dp=3):
    rng = np.random.default_rng(0)
    cu = torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32)
    cv = torch.as_tensor(rng.standard_normal((m, dp)), dtype=torch.float32)

    def loss_fn(p, b):
        return torch.sum((p["body"] - b["tu"][0]) ** 2) + \
            torch.sum((p["head"] - b["tv"][0]) ** 2)
    return loss_fn, {"body": True, "head": False}, cu, cv


@pytest.mark.parametrize("codec", [None, "topk", "randk", "qsgd"])
def test_mass_conserved_under_random_delay_trace(codec):
    """sum(mu) + mass in flight stays m at EVERY tick for random per-edge
    delays, 4x speed tiers and a 0.7 duty availability trace; with a lossy
    codec and frozen local steps the value ledger sum(u) + sum(ef) + in
    flight is conserved too (randk and qsgd draw from the port's own
    generators, so they are held to these properties, not to the
    reference's draws)."""
    from repro_torch import compress as tcompress
    loss_fn, mask, cu, cv = _quad()
    m = cu.shape[0]
    opt = TSGD(lr=0.1 if codec is None else 0.0, momentum=0.9,
               weight_decay=5e-4 if codec is None else 0.0)
    algo = tdfedpgp.DFedPGP(
        loss_fn=loss_fn, mask=mask, opt_u=opt, opt_v=opt, k_v=1, k_u=2,
        codec=None if codec is None else tcompress.make_codec(
            codec, ratio=0.3), codec_gamma=1.0 if codec is None else 0.5)
    prof = tprofiles.tiered(m, spread=4.0, push_delay_max=3,
                            availability=0.7, seed=1)
    rt, s = AsyncRuntime.build(algo, {"body": cu, "head": cv}, prof,
                               depth=4, device="cpu")
    if codec is not None:
        s = s._replace(ref=s.ref + 0.3 * torch.randn(
            s.ref.shape, generator=torch.Generator().manual_seed(42)))
        value0 = float(s.flat.sum() + s.ef.sum())
    rng = np.random.default_rng(0)
    bt = {"tu": cu[:, None], "tv": cv[:, None]}
    gen = torch.Generator().manual_seed(5)
    for t in range(50):
        P = ttopology.to_push_sparse(ttopology.directed_random(gen, m, 3))
        delay = torch.as_tensor(rng.integers(0, 4, P.idx.shape),
                                dtype=torch.int32)
        s, mt = rt.tick(s, P, bt, delay)
        np.testing.assert_allclose(float(mt["mass_total"]), m, rtol=1e-5)
        if codec is not None:
            mail_f, _ = tmbox.in_flight(s.mail)
            np.testing.assert_allclose(
                float(s.flat.sum() + s.ef.sum() + mail_f.sum()), value0,
                rtol=1e-4, atol=1e-3)
    rounds = s.local_round.numpy()
    assert rounds[:2].min() > rounds[-2:].max()     # real heterogeneity
    ev = rt.eval_params(s)
    assert all(bool(torch.isfinite(a).all()) for a in tree.leaves(ev))


def test_participation_gate_freezes_dormant_rows():
    """A gated-off client neither steps nor fires: its row, mu and momenta
    stay bit for bit while mass fired at it lands in its inbox."""
    loss_fn, mask, cu, cv = _quad(m=8)
    m = 8
    algo = tdfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask, k_v=1, k_u=1)
    rt, s0 = AsyncRuntime.build(algo, {"body": cu, "head": cv},
                                tprofiles.uniform(m), depth=2, device="cpu")
    part = torch.tensor([True] * 6 + [False] * 2)
    s, bt = s0, {"tu": cu[:, None], "tv": cv[:, None]}
    for t in range(6):
        P = ttopology.to_push_sparse(ttopology.ring(m))
        s, mt = rt.tick(s, P, bt, participation=part)
        assert int(mt["n_active"]) == 6
        np.testing.assert_allclose(float(mt["mass_total"]), m, rtol=1e-6)
    for name in ("flat", "mu"):
        assert torch.equal(getattr(s, name)[6:], getattr(s0, name)[6:])
    assert torch.equal(s.opt_u.momentum[6:], s0.opt_u.momentum[6:])
    assert float(s.mail.inbox_mu[6:].sum()) > 0.0
    assert (s.local_round[6:] == 0).all() and (s.local_round[:6] > 0).all()
    # the all-ones gate is no gate
    s1, s2 = s0, s0
    for t in range(4):
        P = ttopology.to_push_sparse(ttopology.ring(m))
        s1, _ = rt.tick(s1, P, bt)
        s2, _ = rt.tick(s2, P, bt, participation=torch.ones(
            m, dtype=torch.bool))
    for k, v in _leaves(s1).items():
        np.testing.assert_array_equal(v, _leaves(s2)[k], err_msg=k)


def test_runtime_build_guards():
    loss_fn, mask, cu, cv = _quad(m=8)
    algo = tdfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask)
    params = {"body": cu, "head": cv}
    with pytest.raises(ValueError, match="depth"):
        AsyncRuntime.build(algo, params, tprofiles.tiered(
            8, push_delay_max=5), depth=2, device="cpu")
    with pytest.raises(ValueError, match="mix_fn"):
        AsyncRuntime.build(dataclasses.replace(
            algo, mix_fn_flat=lambda f, mu, r, P: (f, mu)), params,
            tprofiles.uniform(8), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        AsyncRuntime.build(algo, params, tprofiles.uniform(9), device="cpu")
    rt, s = AsyncRuntime.build(algo, params, tprofiles.uniform(8),
                               device="cpu")
    with pytest.raises(ValueError, match="SparseTopology"):
        rt.tick(s, torch.eye(8), {"tu": cu[:, None], "tv": cv[:, None]})
