"""Port parity of the collaboration-graph gauges and the flight recorder
(`repro_torch.obs.graph`, `repro_torch.obs.flight`) against the reference
(`repro.obs.graph`, `repro.obs.flight`): the counterparts of
tests/test_obs_graph.py.

The reference draws its probe vectors and client pairs from
`jax.random`, which torch cannot replay: where a gauge is random the test
computes the reference's draw and injects it (`probes=`, `pairs=`), then
holds the port to the reference's value at rtol 1e-5 / atol 1e-6; the
port's own draws are held to the invariants the reference's tests pin
(full < exponential < ring at m 64, ~0 on the full graph)."""
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopology
from repro.obs import flight as jflight
from repro.obs import graph as jgraph
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.core import dfedpgp, topology
from repro_torch.core.topology import SparseTopology
from repro_torch.hetero import profiles
from repro_torch.hetero.runtime import AsyncRuntime
from repro_torch.obs import flight, graph
from repro_torch.obs import report as obs_report
from repro_torch.optim import SGD
from repro_torch.spec import make_algo_spec

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _topo(P):
    return SparseTopology(_t(P.idx), _t(P.w))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _ref_probes(key, m, n_probes=4):
    """The reference's probe draw inside contraction_estimate."""
    return _t(jax.random.normal(key, (m, n_probes), jnp.float32))


def _ref_pairs(key, m, n_pairs=64):
    """The reference's (i, j) draw inside row_cosine /
    pairwise_distance."""
    ki, kj = jax.random.split(key)
    i = jax.random.randint(ki, (n_pairs,), 0, m)
    j_raw = jax.random.randint(kj, (n_pairs,), 0, max(m - 1, 1))
    j = jnp.where(j_raw >= i, j_raw + 1, j_raw) % m
    return _t(i).long(), _t(j).long()


def _window(kind, m, n=0):
    s = jtopology.get_schedule(kind, m, n, 0)
    return tuple(s.at(t) for t in range(s.period or jgraph.GRAPH_WINDOW))


# ---------------------------------------------------------------------------
# contraction estimate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["full", "exponential", "ring", "random",
                                  "undirected"])
def test_contraction_matches_reference_with_its_probes(kind):
    """With the reference's probes the estimate is the reference's, at
    rtol 1e-5, where the window leaves a disagreement to measure (ring,
    random, undirected).  The full graph and the exponential window reach
    the exact average, after which the probes hold f32 rounding noise
    only, and each engine's rounding gives its own noise: there both
    engines are held to the invariant, ~0 (full) and small (exponential,
    < 0.1; it was 0.0463 and 0.0471 when this was written)."""
    m, key = 64, jax.random.PRNGKey(0)
    win = _window(kind, m, 4)
    want = float(jgraph.contraction_estimate(win, key))
    got = graph.contraction_estimate(tuple(_topo(P) for P in win),
                                     probes=_ref_probes(key, m))
    assert got.dtype == torch.float32 and got.dim() == 0
    if kind == "full":
        assert float(got) < 1e-6 and want < 1e-6
    elif kind == "exponential":
        assert float(got) < 0.1 and want < 0.1
    else:
        _close(float(got), want, kind)


def test_port_contraction_ordering_full_exp_ring():
    """Tighter connectivity -> smaller contraction at m 64, with the
    port's own draws (seeded_generator)."""
    from repro_torch.device import seeded_generator
    m = 64
    rho = {}
    for kind in ("full", "exponential", "ring"):
        s = topology.get_schedule(kind, m, 0, 0)
        window = tuple(s.at(t) for t in range(s.period or
                                              graph.GRAPH_WINDOW))
        rho[kind] = float(graph.contraction_estimate(
            window, seeded_generator(0, graph.GRAPH_STREAM, 0)))
    assert rho["full"] < rho["exponential"] < rho["ring"]
    assert rho["full"] < 1e-6
    assert 0.5 < rho["ring"] < 1.0 + 1e-6


def test_port_contraction_random_degree_tightens():
    m = 64
    gen = torch.Generator().manual_seed(1)
    probes = torch.randn((m, 4), generator=gen)

    def est(n):
        s = topology.get_schedule("random", m, n, 0)
        window = tuple(s.at(t) for t in range(graph.GRAPH_WINDOW))
        return float(graph.contraction_estimate(window, probes=probes))

    assert est(16) < est(2) < 1.0


def test_port_contraction_rejects_empty_window():
    with pytest.raises(ValueError, match="topology"):
        graph.contraction_estimate((), torch.Generator())


def test_port_contraction_on_induced_subgraph():
    m = 32
    s = topology.get_schedule("random", m, 4, 0)
    active = torch.arange(0, m, 2)
    window = tuple(s.induced(t, active, "row") for t in range(4))
    rho = float(graph.contraction_estimate(
        window, torch.Generator().manual_seed(2)))
    assert np.isfinite(rho) and 0.0 <= rho < 1.0 + 1e-6


def test_sparse_topology_matmul_matches_reference():
    P = jtopology.directed_random(jax.random.PRNGKey(9), 10, 3)
    x = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    _close((_topo(P) @ _t(x)).numpy(), np.asarray(P @ jnp.asarray(x)))
    _close((_topo(P) @ _t(x[:, 0])).numpy(),
           np.asarray(P @ jnp.asarray(x[:, 0])))
    F = jtopology.fully_connected(6)
    _close((_topo(F) @ _t(x[:6])).numpy(), np.asarray(F @ jnp.asarray(
        x[:6])))


# ---------------------------------------------------------------------------
# per-edge mass flow == independently accounted moved mass
# ---------------------------------------------------------------------------
def _mu(key, m):
    return np.asarray(jax.random.uniform(key, (m,), minval=0.5, maxval=2.0))


def test_port_edge_mass_flow_matches_dense_sync():
    m = 16
    P = jtopology.directed_random(jax.random.PRNGKey(0), m, 4)
    mu = _mu(jax.random.PRNGKey(1), m)
    D = np.asarray(jtopology.densify(P), np.float64)
    expect = float((D * mu.astype(np.float64)[None, :]).sum()
                   - (np.diag(D) * mu).sum())
    got = float(graph.moved_mass(_topo(P), _t(mu)))
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    flow = graph.edge_mass_flow(_topo(P), _t(mu)).numpy()
    _close(flow, np.asarray(jgraph.edge_mass_flow(P, jnp.asarray(mu))))
    assert (flow >= 0).all()
    rows = np.arange(m)[:, None]
    assert (flow[np.asarray(P.idx) == rows] == 0).all()
    # the dense form of the same flow
    dense = graph.edge_mass_flow(_t(np.asarray(P.dense())), _t(mu))
    _close(float(dense.sum()), expect)


def test_port_edge_mass_flow_matches_dense_async_fired():
    m = 16
    P = jtopology.to_push_sparse(
        jtopology.directed_random(jax.random.PRNGKey(3), m, 4))
    mu = _mu(jax.random.PRNGKey(4), m)
    fired = np.random.default_rng(0).random(m) < 0.5
    D = np.asarray(jtopology.densify(P), np.float64)
    expect = float(sum(mu[j] * (1.0 - D[j, j]) for j in range(m)
                       if fired[j]))
    got = float(graph.moved_mass(_topo(P), _t(mu), fired=_t(fired)))
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    _close(got, float(jgraph.moved_mass(P, jnp.asarray(mu),
                                        fired=jnp.asarray(fired))))


def _quad(m=8, d=6, dp=3):
    rng = np.random.default_rng(0)
    cu = _t(rng.standard_normal((m, d)).astype(np.float32))
    cv = _t(rng.standard_normal((m, dp)).astype(np.float32))

    def loss_fn(p, b):
        return torch.sum((p["body"] - b["tu"][0]) ** 2) + \
            torch.sum((p["head"] - b["tv"][0]) ** 2)
    return loss_fn, {"body": True, "head": False}, cu, cv


def _batches(cu, cv, kv, ku):
    def rep(x, k):
        return x[:, None].repeat(1, k, 1)[:, :, None, :]
    return {"v": {"tu": rep(cu, kv), "tv": rep(cv, kv)},
            "u": {"tu": rep(cu, ku), "tv": rep(cv, ku)}}


def _tick_batch(b, t, k_v):
    src = b["v"] if t < k_v else b["u"]
    off = t if t < k_v else t - k_v
    return {k: v[:, off] for k, v in src.items()}


def _algo(loss_fn, mask):
    opt = SGD(lr=0.05, momentum=0.9)
    return dfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask, opt_u=opt, opt_v=opt,
                           k_v=1, k_u=2, telemetry=True)


def test_port_round_gauge_moved_mass_sync_runtime():
    loss_fn, mask, cu, cv = _quad()
    m = cu.shape[0]
    algo = _algo(loss_fn, mask)
    state, layout = algo.init_flat({"body": cu, "head": cv}, device="cpu")
    mu0 = _mu(jax.random.PRNGKey(7), m)
    state = state._replace(mu=_t(mu0))
    P = jtopology.directed_random(jax.random.PRNGKey(5), m, 3)
    _, metrics = algo.round_fn_flat(state, _topo(P),
                                    _batches(cu, cv, 1, 2), layout)
    D = np.asarray(jtopology.densify(P), np.float64)
    mu64 = mu0.astype(np.float64)
    expect = float((D * mu64[None, :]).sum() - (np.diag(D) * mu64).sum())
    np.testing.assert_allclose(float(metrics["moved_mass"]), expect,
                               rtol=1e-5)


def test_port_round_gauge_moved_mass_sampled_matches_full_at_sample_all():
    loss_fn, mask, cu, cv = _quad()
    m = cu.shape[0]
    algo = _algo(loss_fn, mask)
    b = _batches(cu, cv, 1, 2)
    P = _topo(jtopology.directed_random(jax.random.PRNGKey(6), m, 3))
    active = torch.arange(m, dtype=torch.int32)
    P_act = topology.induced_subgraph(P, active, "row")
    s_full, layout = algo.init_flat({"body": cu, "head": cv}, device="cpu")
    s_samp, _ = algo.init_flat({"body": cu, "head": cv}, device="cpu")
    _, mt_full = algo.round_fn_flat(s_full, P, b, layout)
    _, mt_samp = algo.round_fn_sampled(s_samp, P_act, active, b, layout)
    assert float(mt_full["moved_mass"]) == float(mt_samp["moved_mass"])


def test_port_tick_gauge_moved_mass_async_runtime():
    """Uniform profile: every client fires on the window's last tick with
    mu still at 1, so moved_mass = m - trace(P) there and 0 before."""
    loss_fn, mask, cu, cv = _quad()
    m = cu.shape[0]
    algo = _algo(loss_fn, mask)
    rt, s = AsyncRuntime.build(algo, {"body": cu, "head": cv},
                               profiles.uniform(m), depth=2, device="cpu")
    jP = jtopology.to_push_sparse(
        jtopology.directed_random(jax.random.PRNGKey(8), m, 3))
    b = _batches(cu, cv, 1, 2)
    moved = []
    for t in range(rt.k_total):
        s, mt = rt.tick(s, _topo(jP), _tick_batch(b, t, algo.k_v))
        moved.append((int(mt["n_fired"]), float(mt["moved_mass"])))
    D = np.asarray(jtopology.densify(jP), np.float64)
    for n_fired, mm in moved[:-1]:
        assert n_fired == 0 and mm == 0.0
    assert moved[-1][0] == m
    np.testing.assert_allclose(moved[-1][1], float(m - np.trace(D)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# attribution, degree load, similarity, mailbox ages
# ---------------------------------------------------------------------------
def test_port_edge_delta_attribution_matches_reference():
    m = 8
    P = jtopology.directed_random(jax.random.PRNGKey(0), m, 3)
    flat = np.ones((m, 4), np.float32) * np.arange(1, m + 1,
                                                   dtype=np.float32)[:, None]
    mu = np.full((m,), 2.0, np.float32)
    att = graph.edge_delta_attribution(_topo(P), _t(flat), _t(mu)).numpy()
    rows = np.arange(m)[:, None]
    assert (att[np.asarray(P.idx) == rows] == 0).all()
    idx, w = np.asarray(P.idx), np.asarray(P.w, np.float64)
    znorm = np.linalg.norm(flat.astype(np.float64), axis=1) / 2.0
    expect = w * znorm[idx]
    expect[idx == rows] = 0.0
    np.testing.assert_allclose(att, expect, rtol=1e-5)
    _close(att, np.asarray(jgraph.edge_delta_attribution(
        P, jnp.asarray(flat), jnp.asarray(mu))))
    # a just-fired client's (0, 0) row: floored, no NaN
    mu0 = mu.copy()
    mu0[2] = 0.0
    flat0 = flat.copy()
    flat0[2] = 0.0
    assert np.isfinite(graph.edge_delta_attribution(
        _topo(P), _t(flat0), _t(mu0)).numpy()).all()


def test_port_degree_utilization_flags_starved_client():
    m = 6
    P = jtopology.directed_random(jax.random.PRNGKey(1), m, 2)
    idx = np.asarray(P.idx).copy()
    w = np.asarray(P.w).copy()
    idx[0, :] = 0
    w[0, :] = 0.0
    w[0, 0] = 1.0
    P0 = jtopology.SparseTopology(jnp.asarray(idx), jnp.asarray(w))
    tg = {k: float(v) for k, v in graph.degree_utilization(
        _topo(P0)).items()}
    jg = {k: float(v) for k, v in jgraph.degree_utilization(P0).items()}
    assert tg.keys() == jg.keys()
    for k in tg:
        _close(tg[k], jg[k], k)
    assert tg["in_degree_min"] == 0.0
    assert tg["starved_frac"] == pytest.approx(1.0 / m)
    assert tg["out_degree_max"] >= tg["out_degree_mean"] > 0.0


def test_port_row_cosine_and_distance_match_reference_pairs():
    m, key = 16, jax.random.PRNGKey(3)
    rng = np.random.default_rng(2)
    flat = rng.standard_normal((m, 8)).astype(np.float32)
    mu = rng.uniform(0.5, 1.5, m).astype(np.float32)
    pairs = _ref_pairs(key, m)
    i, j = pairs
    assert bool((i != j).all())
    tg = graph.row_cosine(_t(flat), _t(mu), pairs=pairs)
    jg = jgraph.row_cosine(jnp.asarray(flat), jnp.asarray(mu), key)
    for k in jg:
        _close(float(tg[k]), float(jg[k]), k)
    rows = graph.stack_client_rows({"head": _t(flat), "none": None})
    td = graph.pairwise_distance(rows, pairs=pairs)
    jd = jgraph.pairwise_distance(jgraph.stack_client_rows(
        {"head": jnp.asarray(flat), "none": None}), key)
    for k in jd:
        _close(float(td[k]), float(jd[k]), k)
    # the port's own draw: i != j, in range
    gi, gj = graph.draw_pairs(torch.Generator().manual_seed(0), m)
    assert bool((gi != gj).all()) and int(gi.max()) < m and \
        int(gj.max()) < m


def test_port_row_cosine_identical_rows_and_zero_distance():
    m = 16
    flat = torch.randn((1, 8), generator=torch.Generator().manual_seed(0)
                       ).repeat(m, 1)
    gen = torch.Generator().manual_seed(1)
    g = graph.row_cosine(flat, torch.ones(m), gen)
    assert float(g["row_cos_mean"]) == pytest.approx(1.0, abs=1e-5)
    assert float(g["row_cos_min"]) == pytest.approx(1.0, abs=1e-5)
    d = graph.pairwise_distance(graph.stack_client_rows({"head": flat}),
                                gen)
    assert float(d["head_dist_max"]) == pytest.approx(0.0, abs=1e-5)
    with pytest.raises(ValueError, match="leaves"):
        graph.stack_client_rows({"a": None})


def test_port_mailbox_age_hist_matches_reference():
    depth, m = 4, 3
    slots = np.arange(depth * m, dtype=np.float32).reshape(depth, m)
    h = graph.mailbox_age_hist(_t(slots), tick=5)
    jh = jgraph.mailbox_age_hist(jnp.asarray(slots), tick=5)
    assert set(h) == set(jh) and len(h) == depth
    per_slot = slots.sum(axis=1)
    for d in range(1, depth + 1):
        assert float(h[f"mail_age{d}_mass"]) == float(
            jh[f"mail_age{d}_mass"]) == per_slot[(5 + d) % depth]


def test_port_top_edges_match_reference_string():
    m = 8
    P = jtopology.directed_random(jax.random.PRNGKey(2), m, 3)
    att = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), P.w.shape))
    spec = graph.top_edges(_topo(P), _t(att), k=5)
    assert spec == jgraph.top_edges(P, jnp.asarray(att), k=5)
    edges = obs_report.parse_edges(spec)
    assert 0 < len(edges) <= 5
    vals = [e[2] for e in edges]
    assert vals == sorted(vals, reverse=True)
    assert all(src != dst for src, dst, _ in edges)
    assert obs_report.parse_edges("3->1:0.5|garbage|:|") == [(3, 1, 0.5)]
    assert obs_report.parse_edges("") == []


# ---------------------------------------------------------------------------
# emit_graph_record: schema-valid records in both id spaces
# ---------------------------------------------------------------------------
def _graph_inputs(m=16):
    key = jax.random.PRNGKey(0)
    flat = np.asarray(jax.random.normal(key, (m, 32)))
    mu = np.ones((m,), np.float32)
    head = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (m, 8)))
    return flat, mu, head


@pytest.mark.parametrize("induced", [False, True])
def test_emit_graph_record_matches_reference_with_its_draws(induced):
    """The same window, buffer and draws through both emit functions: every
    gauge of the record at tolerance, the top edges as parsed pairs."""
    from repro import obs as jobs
    m, t0, seed = 16, 1, 0
    flat, mu, head = _graph_inputs(m)
    active = np.arange(0, m, 2, dtype=np.int32) if induced else None
    n = m // 2 if induced else m
    jsched = jtopology.get_schedule("random", m, 4, seed)
    jsink = jobs.RingSink(4)
    jgraph.emit_graph_record(
        jsink, run_id="t", algo="dfedpgp", m=m, seed=seed, schedule=jsched,
        step=2, t0=t0, flat=jnp.asarray(flat), mu=jnp.asarray(mu),
        personal={"head": jnp.asarray(head), "body": None},
        active=None if active is None else jnp.asarray(active))
    kc, ks = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 t0))
    # the port's schedule draws other random tables: hand it the
    # reference's window
    window = {t0 + i: jsched.at(t0 + i) for i in range(graph.GRAPH_WINDOW)}

    class Replay:
        period = 0

        def at(self, t):
            return _topo(window[t])

        def induced(self, t, act, renorm):
            return topology.induced_subgraph(self.at(t), act, renorm)

    tsink = obs.RingSink(4)
    graph.emit_graph_record(
        tsink, run_id="t", algo="dfedpgp", m=m, seed=seed,
        schedule=Replay(), step=2, t0=t0, flat=_t(flat), mu=_t(mu),
        personal={"head": _t(head)}, active=active,
        probes=_ref_probes(kc, n), pairs=_ref_pairs(ks, n))
    jr, tr = jsink.records[0], tsink.records[0]
    obs.record.validate(tr)
    assert set(tr) == set(jr)
    for k, v in jr.items():
        if k == "top_edges":
            ta, ja = obs_report.parse_edges(tr[k]), \
                obs_report.parse_edges(v)
            assert [(s, d) for s, d, _ in ta] == [(s, d) for s, d, _ in ja]
            np.testing.assert_allclose([x for *_, x in ta],
                                       [x for *_, x in ja], rtol=1e-3)
        elif isinstance(v, float):
            _close(tr[k], v, k)
        else:
            assert tr[k] == v, k
    assert tr["mass_total"] == pytest.approx(float(m))
    if induced:
        assert tr["n_active"] == n
        for src, dst, _ in obs_report.parse_edges(tr["top_edges"]):
            assert src < n and dst < n


def test_port_emit_graph_record_full_and_induced():
    m = 16
    sched = topology.get_schedule("random", m, 4, 0)
    flat, mu, head = _graph_inputs(m)
    sink = obs.RingSink(8)
    graph.emit_graph_record(sink, run_id="t", algo="dfedpgp", m=m, seed=0,
                            schedule=sched, step=1, t0=0, flat=_t(flat),
                            mu=_t(mu), personal={"head": _t(head)})
    active = torch.arange(0, m, 2)
    graph.emit_graph_record(sink, run_id="t", algo="dfedpgp", m=m, seed=0,
                            schedule=sched, step=2, t0=1, flat=_t(flat),
                            mu=_t(mu), personal={"head": _t(head)},
                            active=active)
    full, ind = sink.records
    for r in (full, ind):
        obs.record.validate(r)
        assert r["kind"] == "graph" and r["schema"] == 2
        for k in ("contraction", "moved_mass", "row_cos_mean",
                  "head_dist_mean", "in_degree_mean", "top_edges"):
            assert k in r
    assert "n_active" not in full
    assert ind["n_active"] == m // 2
    assert ind["mass_total"] == pytest.approx(float(m))
    for src, dst, _ in obs_report.parse_edges(ind["top_edges"]):
        assert src < m // 2 and dst < m // 2


def test_port_graph_records_ride_the_simulator_sync():
    from repro_torch.fl.simulator import SimConfig, run_experiment
    sink = obs.RingSink(64)
    sp = make_algo_spec("dfedpgp", telemetry=True, graph_every=2)
    sim = SimConfig(m=8, rounds=4, batch=4, k_local=2, k_personal=1,
                    n_train=16, n_test=8, spec=sp)
    run_experiment("dfedpgp", sim, sink=sink, device="cpu")
    kinds = [r["kind"] for r in sink.records]
    assert kinds.count("graph") == 2 and kinds.count("round") == 4
    for r in sink.records:
        obs.record.validate(r)
    assert [r["step"] for r in sink.records if r["kind"] == "graph"] \
        == [2, 4]
    assert all("moved_mass" in r for r in sink.records
               if r["kind"] == "round")


def test_port_graph_records_ride_the_simulator_async():
    from repro_torch.fl.simulator import SimConfig, run_experiment
    sink = obs.RingSink(64)
    sp = make_algo_spec("dfedpgp", telemetry=True, graph_every=2)
    sim = SimConfig(m=8, rounds=2, batch=4, k_local=2, k_personal=1,
                    n_train=16, n_test=8, runtime="async",
                    hetero="tiered", push_delay_max=2, mailbox_depth=4,
                    spec=sp)
    run_experiment("dfedpgp", sim, sink=sink, device="cpu")
    gr = [r for r in sink.records if r["kind"] == "graph"]
    assert len(gr) == 1 and gr[0]["step"] == 2
    obs.record.validate(gr[0])
    assert "staleness_max" in gr[0]
    assert all(f"mail_age{d}_mass" in gr[0] for d in range(1, 5))
    assert gr[0]["mass_total"] == pytest.approx(8.0, rel=1e-5)
    assert all("moved_mass" in r for r in sink.records
               if r["kind"] == "tick")


def test_port_spec_graph_every_knob_is_loud():
    with pytest.raises(ValueError, match="graph_every"):
        make_algo_spec("dfedpgp", graph_every=-1, telemetry=True)
    with pytest.raises(ValueError, match="telemetry"):
        make_algo_spec("dfedpgp", graph_every=4)
    assert make_algo_spec("dfedpgp", graph_every=4,
                          telemetry=True).graph_every == 4


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def _round(step, run="r0", **gauges):
    return obs.round_record(run=run, algo="dfedpgp", step=step,
                            wire_bytes=0, **gauges)


def test_port_flight_constants_are_the_reference():
    for name in ("GAP_GROWTH", "MASS_RTOL", "EF_FLOOR", "STALENESS_LIMIT",
                 "WINDOW", "COOLDOWN"):
        assert getattr(flight, name) == getattr(jflight, name), name


def test_port_flight_recorder_mass_drift_alert_and_postmortem(tmp_path,
                                                              capsys):
    inner = obs.RingSink(64)
    fr = flight.FlightRecorder(inner, dump_dir=str(tmp_path))
    for s in range(1, 6):
        fr.emit(_round(s, mass_total=8.0))
    fr.emit(_round(6, mass_total=8.5))
    assert len(fr.alerts) == 1
    alert = fr.alerts[0]
    assert alert["kind"] == "alert" and alert["detector"] == "mass-drift"
    assert "drifted" in alert["reason"]
    obs.record.validate(alert)
    assert inner.records[-1]["kind"] == "alert"
    assert len(fr.dumps) == 1 and fr.dumps[0].endswith(".json.gz")
    payload = flight.load_postmortem(fr.dumps[0])
    assert payload["schema"] == obs.SCHEMA_VERSION
    assert payload["alert"]["detector"] == "mass-drift"
    assert any(r.get("step") == 6 for r in payload["records"])
    assert jflight.load_postmortem(fr.dumps[0]) == payload
    assert obs_report.main([fr.dumps[0], "--postmortem"]) == 0
    out = capsys.readouterr().out
    assert "ALERT" in out and "mass-drift" in out
    # the reference's report renders the port's dump the same way
    assert jreport.main([fr.dumps[0], "--postmortem"]) == 0
    assert capsys.readouterr().out == out


def test_port_flight_recorder_cooldown_one_alert_per_anomaly(tmp_path):
    fr = flight.FlightRecorder(dump_dir=str(tmp_path), cooldown=10)
    fr.emit(_round(1, mass_total=8.0))
    for s in range(2, 8):
        fr.emit(_round(s, mass_total=9.0))
    assert len(fr.alerts) == 1


def test_port_flight_recorder_consensus_growth_and_streams(tmp_path):
    fr = flight.FlightRecorder(dump_dir=str(tmp_path), window=4)
    for s in range(1, 5):
        fr.emit(_round(s, run="A", consensus_gap_mean=1.0))
        fr.emit(_round(s, run="B", consensus_gap_mean=1.0))
    fr.emit(_round(5, run="A", consensus_gap_mean=5.0))
    fr.emit(_round(5, run="B", consensus_gap_mean=1.1))
    assert len(fr.alerts) == 1
    assert fr.alerts[0]["run"] == "A"
    assert fr.alerts[0]["detector"] == "consensus-growth"


def test_port_flight_recorder_ef_and_staleness_detectors(tmp_path):
    fr = flight.FlightRecorder(dump_dir=str(tmp_path))
    fr.emit(_round(1, ef_ratio=0.01))
    assert fr.alerts[-1]["detector"] == "ef-blowup"
    fr2 = flight.FlightRecorder(dump_dir=str(tmp_path))
    fr2.emit(obs.tick_record(run="r", algo="a", step=1, vtime=1.0,
                             wire_bytes=0, staleness_max=500.0))
    assert fr2.alerts[-1]["detector"] == "starved-client"
    fr3 = flight.FlightRecorder(dump_dir=str(tmp_path), ef_floor=None)
    fr3.emit(_round(1, ef_ratio=0.01))
    assert fr3.alerts == []


def test_port_flight_recorder_passthrough_is_byte_identical(tmp_path):
    inner = obs.RingSink(8)
    fr = flight.FlightRecorder(inner, dump_dir=str(tmp_path))
    rec = _round(1, mass_total=8.0)
    fr.emit(rec)
    assert inner.records[0] is rec
    assert fr.records == [rec]


def test_port_load_postmortem_rejects_newer_schema(tmp_path):
    p = tmp_path / "pm.json.gz"
    with gzip.open(p, "wt") as f:
        json.dump({"schema": obs.SCHEMA_VERSION + 1, "alert": {},
                   "records": []}, f)
    with pytest.raises(ValueError, match="newer"):
        flight.load_postmortem(str(p))
    assert obs_report.main([str(p), "--postmortem"]) == 1


def test_port_flight_recorder_over_a_simulator_run(tmp_path):
    """A healthy run through the recorder trips nothing; the same stream
    with mu scaled by 1.01 trips mass-drift on its first record after the
    anchor."""
    from repro_torch.fl.simulator import SimConfig, run_experiment
    ring = obs.RingSink(64)
    fr = flight.FlightRecorder(ring, dump_dir=str(tmp_path))
    sp = make_algo_spec("dfedpgp", n_neighbors=2, telemetry=True)
    sim = SimConfig(m=6, rounds=3, batch=4, k_local=1, k_personal=1,
                    n_train=16, n_test=8, spec=sp)
    run_experiment("dfedpgp", sim, sink=fr, device="cpu")
    assert fr.alerts == [] and len(ring.records) == 3
    bad = dict(ring.records[-1], step=4,
               mass_total=ring.records[-1]["mass_total"] * 1.01)
    fr.emit(bad)
    assert [a["detector"] for a in fr.alerts] == ["mass-drift"]
    assert flight.load_postmortem(fr.dumps[0])["alert"]["step"] == 4
