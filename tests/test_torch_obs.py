"""Port parity of the telemetry spine (`repro_torch.obs`) against the
reference (`repro.obs`): each gauge equals the reference's on the same
inputs (rtol 1e-5, atol 1e-6; `wire_edges` exact), the round and tick
gauges of both engines agree on the same states, telemetry on leaves the
state bit for bit what it is with telemetry off (resident, sampled and
async rounds), the records, sinks and report CLI behave as the
reference's, and each package's `report --check` accepts the other's
JSONL."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import dfedpgp as jdfedpgp
from repro.core import topology as jtopology
from repro.hetero import profiles as jprofiles
from repro.hetero.runtime import AsyncRuntime as JAsyncRuntime
from repro.obs import gauges as jgauges
from repro.obs import report as jreport
from repro.optim import SGD as JSGD
from repro_torch import compress as tcompress
from repro_torch import obs
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core.topology import SparseTopology
from repro_torch.hetero import profiles as tprofiles
from repro_torch.hetero.runtime import AsyncRuntime
from repro_torch.obs import gauges, record, report
from repro_torch.optim import SGD as TSGD
from repro_torch.serve import ServeMeter

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
# every gauge against the reference's on the same inputs
RTOL, ATOL = 1e-5, 1e-6


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def _topo(P):
    """A reference SparseTopology, or its dense (m, m) matrix."""
    if not hasattr(P, "idx"):
        return _t(P)
    return SparseTopology(_t(P.idx), _t(P.w))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_gauges(tg: dict, jg: dict):
    assert set(tg) == set(jg), sorted(set(tg) ^ set(jg))
    for k in tg:
        _close(float(tg[k]), float(jg[k]), k)


# ---------------------------------------------------------------------------
# the gauges on the same inputs
# ---------------------------------------------------------------------------
def _inputs(m=10, d=7, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    mu = rng.uniform(0.4, 1.6, m).astype(np.float32)
    return flat, mu


def test_consensus_gap_and_norms_match_reference():
    flat, mu = _inputs()
    after = flat + 0.3 * _inputs(seed=1)[0]
    _close_gauges(gauges.consensus_gap(_t(flat), _t(mu)),
                  jgauges.consensus_gap(jnp.asarray(flat), jnp.asarray(mu)))
    _close(float(gauges.buffer_update_norm(_t(flat), _t(after))),
           float(jgauges.buffer_update_norm(jnp.asarray(flat),
                                            jnp.asarray(after))))
    _close(float(gauges.ef_signal_ratio(_t(flat), _t(after))),
           float(jgauges.ef_signal_ratio(jnp.asarray(flat),
                                         jnp.asarray(after))))


@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_chunked_gauges_match_reference(monkeypatch, chunk):
    """The gauges taken over column chunks of at most `chunk` elements (as
    a full-width buffer takes them, `gauges.GAUGE_CHUNK`) equal the
    reference's unchunked gauges."""
    monkeypatch.setattr(gauges, "GAUGE_CHUNK", chunk)
    flat, mu = _inputs(m=4, d=37, seed=2)
    after = flat + 0.3 * _inputs(m=4, d=37, seed=3)[0]
    assert len(gauges._column_slices(_t(flat))) > 1
    _close_gauges(gauges.consensus_gap(_t(flat), _t(mu)),
                  jgauges.consensus_gap(jnp.asarray(flat), jnp.asarray(mu)))
    _close(float(gauges.buffer_update_norm(_t(flat), _t(after))),
           float(jgauges.buffer_update_norm(jnp.asarray(flat),
                                            jnp.asarray(after))))
    _close(gauges.l2_norm(_t(after), dim=1).numpy(),
           jnp.linalg.norm(jnp.asarray(after), axis=1))
    _close(float(gauges.l2_norm(_t(after))),
           float(jnp.linalg.norm(jnp.asarray(after))))


@pytest.mark.parametrize("with_mask", [False, True])
def test_mass_ledger_matches_reference(with_mask):
    _, mu = _inputs()
    mask = np.arange(10) < 4 if with_mask else None
    extra = np.float32(0.7)
    tg = gauges.mass_ledger(_t(mu), None if mask is None else _t(mask),
                            torch.tensor(extra))
    jg = jgauges.mass_ledger(jnp.asarray(mu),
                             None if mask is None else jnp.asarray(mask),
                             jnp.asarray(extra))
    _close_gauges(tg, jg)
    _close(float(tg["mass_active"]) + float(tg["mass_dormant"])
           + float(tg["mass_in_flight"]), float(tg["mass_total"]))
    if not with_mask:
        assert float(tg["mass_dormant"]) == 0.0


def test_wire_edges_exact_like_reference():
    m = 12
    P = jtopology.directed_random(jax.random.PRNGKey(4), m, 3)
    fired = np.arange(m) % 3 == 0
    assert int(gauges.wire_edges(_topo(P))) == int(jgauges.wire_edges(P)) \
        == gauges.edge_count(_topo(P)) == jgauges.edge_count(P)
    assert int(gauges.wire_edges(_topo(P), _t(fired))) == \
        int(jgauges.wire_edges(P, jnp.asarray(fired)))
    D = np.asarray(P.dense())
    assert int(gauges.wire_edges(_t(D))) == int(jgauges.wire_edges(
        jnp.asarray(D)))
    assert int(gauges.wire_edges(_t(D), _t(fired))) == int(
        jgauges.wire_edges(jnp.asarray(D), jnp.asarray(fired)))
    assert gauges.wire_edges(_topo(P)).dtype == torch.int32


def test_async_gauges_match_reference():
    rng = np.random.default_rng(3)
    local_round = rng.integers(0, 6, 10).astype(np.int32)
    slots = np.where(rng.random((3, 10)) < 0.4, rng.random((3, 10)),
                     0.0).astype(np.float32)
    inbox = np.where(rng.random(10) < 0.3, rng.random(10), 0.0).astype(
        np.float32)
    _close_gauges(gauges.staleness_gauges(_t(local_round)),
                  jgauges.staleness_gauges(jnp.asarray(local_round)))
    _close_gauges(gauges.mailbox_gauges(_t(slots), _t(inbox)),
                  jgauges.mailbox_gauges(jnp.asarray(slots),
                                         jnp.asarray(inbox)))


def test_host_meters_match_reference():
    from repro import compress as jcompress
    d = 64
    for kind in (None, "identity", "topk", "qsgd"):
        tc = tcompress.get_codec(kind, ratio=0.25)
        jc = jcompress.get_codec(kind, ratio=0.25)
        assert gauges.payload_row_bytes(tc, d) == \
            jgauges.payload_row_bytes(jc, d)
        assert gauges.bootstrap_bytes(tc, 8, d) == \
            jgauges.bootstrap_bytes(jc, 8, d)
    assert gauges.payload_row_bytes(None, d) == 4 * d + \
        tcompress.MU_BYTES
    a = np.zeros((3, 4), np.float32)
    assert gauges.accounted_bytes(_t(a), [torch.zeros(2, dtype=torch.int64),
                                         a]) == \
        jgauges.accounted_bytes(jnp.asarray(a), [
            np.zeros(2, np.int64), a]) == 48 + 16 + 48
    if not torch.cuda.is_available():
        assert gauges.peak_device_memory() is None


def test_to_host_keeps_kinds_in_one_pass():
    vals = {"f": torch.tensor(1.5), "i": torch.tensor(7, dtype=torch.int32),
            "b": torch.tensor(True), "py": 3, "none": None,
            "vec": torch.ones(3)}
    host = gauges.to_host(vals)
    assert host == {"f": 1.5, "i": 7, "b": True, "py": 3, "none": None}
    assert isinstance(host["i"], int) and isinstance(host["f"], float)
    assert list(host) == ["f", "i", "b", "py", "none"]


def test_consensus_gap_monotone_under_full_graph_averaging():
    m, d = 8, 5
    flat = torch.randn((m, d), generator=torch.Generator().manual_seed(1))
    mu = torch.ones(m)
    P = 0.5 * torch.eye(m) + 0.5 * torch.full((m, m), 1.0 / m)
    gaps = []
    for _ in range(6):
        g = gauges.consensus_gap(flat, mu)
        gaps.append(float(g["consensus_gap_mean"]))
        assert float(g["consensus_gap_max"]) >= gaps[-1] - 1e-7
        flat, mu = P @ flat, P @ mu
    assert all(b < a * 0.75 for a, b in zip(gaps, gaps[1:])), gaps
    assert gaps[-1] < 1e-1 * gaps[0]


def test_ef_signal_ratio_is_the_auto_gamma():
    flat = torch.randn((4, 7), generator=torch.Generator().manual_seed(3))
    assert float(gauges.ef_signal_ratio(flat, torch.zeros_like(flat))) \
        == pytest.approx(1.0, rel=1e-6)
    assert 0.0 < float(gauges.ef_signal_ratio(flat, 100.0 * flat)) < 0.02
    loss_fn, mask, cu, cv = _tquad(4)
    algo = tdfedpgp.DFedPGP(loss_fn=loss_fn, mask=mask,
                            codec=tcompress.make_codec("topk", ratio=0.25),
                            codec_gamma="auto")
    want = torch.clamp(gauges.ef_signal_ratio(cu, 0.5 * cu), 0.05, 1.0)
    assert torch.equal(algo._gamma_value(cu, 0.5 * cu), want)


# ---------------------------------------------------------------------------
# the rounds' gauges: both engines on one closed-form harness
# ---------------------------------------------------------------------------
def _np_quad(m=8, d=6, dp=3):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((m, dp)).astype(np.float32))


def _tquad(m=8):
    cu, cv = _np_quad(m)

    def loss_fn(p, b):
        return torch.sum((p["body"] - b["tu"][0]) ** 2) + \
            torch.sum((p["head"] - b["tv"][0]) ** 2)
    return loss_fn, {"body": True, "head": False}, _t(cu), _t(cv)


def _jquad(m=8):
    cu, cv = _np_quad(m)

    def loss_fn(p, b):
        return jnp.sum((p["body"] - b["tu"][0]) ** 2) + \
            jnp.sum((p["head"] - b["tv"][0]) ** 2)
    return loss_fn, {"body": True, "head": False}, jnp.asarray(cu), \
        jnp.asarray(cv)


def _batches(cu, cv, k, xp):
    def rep(x):
        return xp.repeat(x[:, None], k, 1)[..., None, :]
    return {"v": {"tu": rep(cu), "tv": rep(cv)},
            "u": {"tu": rep(cu), "tv": rep(cv)}}


def _tbatches(cu, cv, k):
    def rep(x):
        return x[:, None].repeat(1, k, 1)[:, :, None, :]
    return {"v": {"tu": rep(cu), "tv": rep(cv)},
            "u": {"tu": rep(cu), "tv": rep(cv)}}


def _pair(m=8, codec=None, **kw):
    jl, jmask, jcu, jcv = _jquad(m)
    tl, tmask, tcu, tcv = _tquad(m)
    extra = {}
    if codec is not None:
        from repro import compress as jcompress
        extra = dict(codec_gamma=0.5)
        jc = jcompress.make_codec(codec, ratio=0.25)
        tc = tcompress.make_codec(codec, ratio=0.25)
    else:
        jc = tc = None
    common = dict(k_v=1, k_u=2, lr_decay=0.99, **extra, **kw)
    ja = jdfedpgp.DFedPGP(loss_fn=jl, mask=jmask, opt_u=JSGD(
        lr=0.1, momentum=0.9, weight_decay=5e-4), opt_v=JSGD(
        lr=0.1, momentum=0.9, weight_decay=5e-4), codec=jc, **common)
    ta = tdfedpgp.DFedPGP(loss_fn=tl, mask=tmask, opt_u=TSGD(
        lr=0.1, momentum=0.9, weight_decay=5e-4), opt_v=TSGD(
        lr=0.1, momentum=0.9, weight_decay=5e-4), codec=tc, **common)
    return ja, ta, (jcu, jcv), (tcu, tcv)


ROUND_GAUGES = ("consensus_gap_mean", "consensus_gap_max", "mass_active",
                "mass_dormant", "mass_in_flight", "mass_total",
                "update_norm", "grad_norm", "wire_edges", "moved_mass")


def _assert_flat_states_equal(a, b):
    for x, y in ((a.flat, b.flat), (a.mu, b.mu),
                 (a.opt_u.momentum, b.opt_u.momentum),
                 (a.personal["head"], b.personal["head"]),
                 (a.opt_v.momentum["head"], b.opt_v.momentum["head"])):
        assert torch.equal(x, y)
    for x, y in ((a.ef, b.ef), (a.ref, b.ref)):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("codec", [None, "topk"])
def test_resident_round_gauges_match_reference_and_off_is_bitwise(codec):
    """3 column-stochastic rounds (mu drifts): the port's telemetry gauges
    equal the reference's, and the telemetry-on state is bit for bit the
    telemetry-off state."""
    ja, ta, (jcu, jcv), (tcu, tcv) = _pair(codec=codec, telemetry=True)
    t_off = dataclasses.replace(ta, telemetry=False)
    js, jl = ja.init_flat({"body": jcu, "head": jcv})
    s_on, tl = ta.init_flat({"body": tcu, "head": tcv}, device="cpu")
    s_off, _ = t_off.init_flat({"body": tcu, "head": tcv}, device="cpu")
    jb, tb = _batches(jcu, jcv, 2, jnp), _tbatches(tcu, tcv, 2)
    sched = jtopology.TopologySchedule.random(8, 3, seed=13)
    jround = jax.jit(lambda s, P, b: ja.round_fn_flat(s, P, b, jl))
    for t in range(3):
        P = jtopology.to_column_stochastic(sched.at(t))
        js, jm = jround(js, P, jb)
        s_on, m_on = ta.round_fn_flat(s_on, _topo(P), tb, tl)
        s_off, m_off = t_off.round_fn_flat(s_off, _topo(P), tb, tl)
        keys = ROUND_GAUGES + (("ef_ratio",) if codec else ())
        for k in keys:
            assert k in m_on and k not in m_off, k
            _close(float(m_on[k]), float(jm[k]), k)
        assert int(m_on["wire_edges"]) == int(jm["wire_edges"])
        for k in m_off:
            assert torch.equal(m_off[k], m_on[k]), k
    assert float((s_on.mu - 1.0).abs().max()) > 1e-3
    _assert_flat_states_equal(s_on, s_off)


@pytest.mark.parametrize("codec", [None, "topk"])
def test_sampled_round_gauges_match_reference_and_off_is_bitwise(codec):
    from repro.core import sampling as jsampling
    ja, ta, (jcu, jcv), (tcu, tcv) = _pair(codec=codec, telemetry=True)
    t_off = dataclasses.replace(ta, telemetry=False)
    js, jl = ja.init_flat({"body": jcu, "head": jcv})
    s_on, tl = ta.init_flat({"body": tcu, "head": tcv}, device="cpu")
    s_off, _ = t_off.init_flat({"body": tcu, "head": tcv}, device="cpu")
    jb, tb = _batches(jcu, jcv, 2, jnp), _tbatches(tcu, tcv, 2)
    sched = jtopology.TopologySchedule.random(8, 3, seed=13)
    sampler = jsampling.ParticipationSampler("uniform", m=8, frac=0.5,
                                             seed=5)
    for t in range(3):
        active = np.asarray(sampler.active_at(t))
        P_act = jtopology.induced_subgraph(sched.at(t), jnp.asarray(active),
                                           "row")
        jba = jax.tree.map(lambda a: a[active], jb)
        tba = {p: {k: v[torch.as_tensor(active).long()] for k, v in
                   bb.items()} for p, bb in tb.items()}
        js, jm = ja.round_fn_sampled(js, P_act, jnp.asarray(active), jba, jl)
        s_on, m_on = ta.round_fn_sampled(s_on, _topo(P_act), active, tba, tl)
        s_off, _ = t_off.round_fn_sampled(s_off, _topo(P_act), active, tba,
                                          tl)
        keys = ROUND_GAUGES + (("ef_ratio",) if codec else ())
        for k in keys:
            _close(float(m_on[k]), float(jm[k]), k)
    assert float(m_on["mass_dormant"]) > 0
    _close(float(m_on["mass_active"]) + float(m_on["mass_dormant"]),
           float(m_on["mass_total"]))
    _assert_flat_states_equal(s_on, s_off)


def test_round_fn_tree_rejects_telemetry():
    _, ta, _, (tcu, tcv) = _pair(telemetry=True)
    s = ta.init({"body": tcu, "head": tcv}, device="cpu")
    P = SparseTopology(torch.arange(8, dtype=torch.int32)[:, None],
                       torch.ones(8, 1))
    with pytest.raises(ValueError, match="telemetry"):
        ta.round_fn(s, P, _tbatches(tcu, tcv, 2))


TICK_GAUGES = ("consensus_gap_mean", "consensus_gap_max", "mass_active",
               "mass_dormant", "mass_in_flight", "mass_total",
               "staleness_mean", "staleness_max", "mailbox_slot_occupancy",
               "mailbox_inbox_occupancy", "mailbox_slot_mass",
               "mailbox_inbox_mass", "update_norm", "moved_mass")


@pytest.mark.parametrize("codec", [None, "topk"])
def test_tick_gauges_match_reference_and_off_is_bitwise(codec):
    """8 ticks of tiered speeds, delays up to 2, duty 0.8: every tick
    gauge against the reference's jitted tick; state, mailbox included,
    bitwise the telemetry-off runtime's."""
    m = 6
    ja, ta, (jcu, jcv), (tcu, tcv) = _pair(m, codec=codec, telemetry=True)
    t_off = dataclasses.replace(ta, telemetry=False)
    jprof = jprofiles.tiered(m, spread=3.0, push_delay_max=2,
                             availability=0.8, seed=1)
    tprof = tprofiles.tiered(m, spread=3.0, push_delay_max=2,
                             availability=0.8, seed=1)
    jrt, js = JAsyncRuntime.build(ja, {"body": jcu, "head": jcv}, jprof,
                                  depth=3)
    rt_on, s_on = AsyncRuntime.build(ta, {"body": tcu, "head": tcv}, tprof,
                                     depth=3, device="cpu")
    rt_off, s_off = AsyncRuntime.build(t_off, {"body": tcu, "head": tcv},
                                       tprof, depth=3, device="cpu")
    jtick = jax.jit(lambda s, p, b: jrt.tick(s, p, b))
    jbt = {"tu": jcu[:, None], "tv": jcv[:, None]}
    tbt = {"tu": tcu[:, None], "tv": tcv[:, None]}
    fired = 0
    for t in range(8):
        P = jtopology.to_push_sparse(jtopology.directed_random(
            jax.random.PRNGKey(300 + t), m, 2))
        js, jm = jtick(js, P, jbt)
        s_on, m_on = rt_on.tick(s_on, _topo(P), tbt)
        s_off, m_off = rt_off.tick(s_off, _topo(P), tbt)
        keys = TICK_GAUGES + (("ef_ratio",) if codec else ())
        for k in keys:
            assert k in m_on and (k not in m_off or k == "mass_total"), k
            _close(float(m_on[k]), float(jm[k]), f"tick {t} {k}")
        _close(float(m_on["mass_total"]), m)
        fired += int(m_on["n_fired"])
    assert fired > 0
    for name in ("flat", "mu", "phase", "local_round", "ef", "ref"):
        a, b = getattr(s_on, name), getattr(s_off, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(s_on.opt_u.momentum, s_off.opt_u.momentum)
    for a, b in zip(s_on.mail, s_off.mail):
        assert torch.equal(a, b)
    assert s_on.clock.t == s_off.clock.t
    assert torch.equal(s_on.clock.next_time, s_off.clock.next_time)


# ---------------------------------------------------------------------------
# records, sinks, report
# ---------------------------------------------------------------------------
def test_record_schema_constants_are_the_reference():
    from repro.obs import record as jrecord
    assert record.SCHEMA_VERSION == jrecord.SCHEMA_VERSION
    assert record._ENVELOPE == jrecord._ENVELOPE
    assert record._REQUIRED == jrecord._REQUIRED


def test_port_record_roundtrip_jsonl(tmp_path):
    recs = [
        obs.round_record(run="r", algo="dfedpgp", step=1, loss=0.5,
                         wire_bytes=1024, mass_total=8.0),
        obs.tick_record(run="r", algo="dfedpgp", step=2, vtime=3.5,
                        wire_bytes=2048),
        obs.serve_record(run="s", step=1, path="fused", batch=64,
                         latency_ms=1.25),
    ]
    p = tmp_path / "run.jsonl"
    with obs.JsonlSink(str(p)) as sink:
        for r in recs:
            sink.emit(r)
    back = list(record.load_jsonl(str(p)))
    assert back == recs
    assert record.schema_of(back) == obs.SCHEMA_VERSION
    assert list(jobs.record.load_jsonl(str(p))) == recs
    # 0-d tensors unwrap; non-finite floats map to None
    r = obs.round_record(step=0, wire_bytes=0, gap=torch.tensor(2.0),
                         n=torch.tensor(3, dtype=torch.int32),
                         bad=float("nan"))
    assert r["gap"] == 2.0 and r["n"] == 3 and r["bad"] is None
    record.validate(r)
    assert record.dumps(r) == jobs.record.dumps(r)
    assert record.render(r) == jobs.record.render(r)


def test_port_record_validation_rejects_malformed():
    with pytest.raises(ValueError, match="required"):
        record.validate(record.make_record("round", step=1))
    with pytest.raises(ValueError, match="kind"):
        record.validate(record.make_record("vibes", step=1))
    newer = obs.round_record(step=1, wire_bytes=0)
    newer["schema"] = obs.SCHEMA_VERSION + 1
    with pytest.raises(ValueError, match="newer"):
        record.validate(newer)
    bad = obs.round_record(step=1, wire_bytes=0)
    bad["blob"] = [1, 2, 3]
    with pytest.raises(ValueError, match="JSON scalar"):
        record.validate(bad)
    sink = obs.JsonlSink("/dev/null")
    with pytest.raises(ValueError):
        sink.emit({"kind": "round"})
    sink.close()
    with pytest.raises(ValueError, match="closed"):
        sink.emit(obs.round_record(step=1, wire_bytes=0))


def test_port_sinks_ring_tee_null():
    ring = obs.RingSink(capacity=3)
    for i in range(5):
        ring.emit(obs.round_record(step=i, wire_bytes=i))
    assert [r["step"] for r in ring.records] == [2, 3, 4]
    assert ring.last("round")["step"] == 4
    assert ring.last("serve") is None
    ring2 = obs.RingSink()
    tee = obs.TeeSink(ring2, obs.NULL_SINK)
    tee.emit(obs.serve_record(step=1, path="fused", batch=1,
                              latency_ms=0.5))
    assert ring2.last("serve")["batch"] == 1
    for s in (ring, ring2, tee, obs.NULL_SINK):
        assert isinstance(s, obs.MetricsSink)
        s.close()


def _jsonl(path, recs):
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def test_port_report_check_gates_mass_drift(tmp_path, capsys):
    ok, drift = tmp_path / "ok.jsonl", tmp_path / "drift.jsonl"
    _jsonl(ok, [obs.round_record(run="a", step=i, wire_bytes=100 * i,
                                 mass_total=8.0 + i * 1e-6)
                for i in range(4)])
    _jsonl(drift, [obs.round_record(run="a", step=i, wire_bytes=100 * i,
                                    mass_total=8.0 + i * 0.5)
                   for i in range(4)])
    assert report.MASS_RTOL == jreport.MASS_RTOL
    assert report.main([str(ok), "--check"]) == 0
    assert "report: OK" in capsys.readouterr().out
    assert report.main([str(drift), "--check"]) == 1
    assert "MASS LEDGER DRIFT" in capsys.readouterr().err
    both = tmp_path / "both.jsonl"
    _jsonl(both, [obs.round_record(run="a", step=0, wire_bytes=0,
                                   mass_total=8.0),
                  obs.round_record(run="b", step=0, wire_bytes=0,
                                   mass_total=16.0)])
    assert report.main([str(both), "--check"]) == 0
    assert report.main([str(both), "--kind", "serve"]) == 1
    capsys.readouterr()


def test_port_report_reads_schema_v1_fixture(capsys):
    fixture = ROOT / "tests" / "data" / "schema_v1.jsonl"
    recs = list(record.load_jsonl(str(fixture)))
    assert recs and record.schema_of(recs) == 1
    assert {r["kind"] for r in recs} == {"round", "tick", "serve"}
    assert report.main([str(fixture), "--check"]) == 0
    out = capsys.readouterr().out
    assert "schema v1" in out and "report: OK" in out


def test_port_newer_schema_jsonl_rejected_loudly(tmp_path, capsys):
    p = tmp_path / "future.jsonl"
    rec = obs.round_record(run="f", algo="a", step=1, wire_bytes=0)
    rec["schema"] = obs.SCHEMA_VERSION + 1
    p.write_text(json.dumps(rec) + "\n")
    assert report.main([str(p), "--check"]) == 1
    assert "newer" in capsys.readouterr().err


def test_port_report_diff_and_exit_codes(tmp_path, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _jsonl(a, [obs.round_record(run="a", algo="x", step=s, loss=1.0 / s,
                                mass_total=8.0, wire_bytes=100 * s)
               for s in (1, 2, 3)])
    _jsonl(b, [obs.round_record(run="b", algo="x", step=s, loss=0.5 / s,
                                mass_total=8.0, wire_bytes=100 * s)
               for s in (1, 2)])
    assert report.main([str(a), str(b), "--diff"]) == 0
    out = capsys.readouterr().out
    assert "diff:round" in out and "d_loss" in out
    lines = [ln for ln in out.splitlines() if ln.strip()
             and ln.split()[0].isdigit()]
    assert [ln.split()[0] for ln in lines] == ["1", "2"]
    assert "-0.5" in lines[0]
    assert report.main([str(a), "--diff"]) == 2
    c = tmp_path / "c.jsonl"
    _jsonl(c, [obs.serve_record(run="c", step=1, path="fused", batch=1,
                                latency_ms=1.0)])
    assert report.main([str(a), str(c), "--diff"]) == 1
    assert "no step-aligned" in capsys.readouterr().err
    assert report.main([str(tmp_path / "missing.jsonl")]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the simulator's JSONL, across the packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_jsonl(tmp_path_factory):
    """A sync and an async telemetry run of the port with graph records,
    and a sampled one, in one JSONL."""
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.spec import make_algo_spec
    spec = make_algo_spec("dfedpgp", topology="random", n_neighbors=2,
                          telemetry=True, graph_every=2)
    sim = SimConfig(m=6, rounds=3, n_train=16, n_test=8, batch=8,
                    k_local=1, k_personal=1, spec=spec)
    p = tmp_path_factory.mktemp("obs") / "port.jsonl"
    with obs.JsonlSink(str(p)) as sink:
        run_experiment("dfedpgp", sim, eval_every=2, sink=sink,
                       device="cpu")
        run_experiment("dfedpgp", dataclasses.replace(
            sim, runtime="async", hetero="tiered", push_delay_max=2),
            eval_every=2, sink=sink, device="cpu")
        sampled = make_algo_spec("dfedpgp", n_neighbors=2, telemetry=True,
                                 graph_every=1, participation="uniform",
                                 participation_frac=0.5)
        run_experiment("dfedpgp", dataclasses.replace(sim, spec=sampled),
                       sink=sink, device="cpu")
    return p


def test_port_jsonl_passes_both_reports(port_jsonl, capsys):
    recs = list(record.load_jsonl(str(port_jsonl)))
    kinds = [r["kind"] for r in recs]
    assert set(kinds) == {"round", "tick", "graph"}
    assert kinds.count("round") == 6 and kinds.count("tick") == 3
    assert kinds.count("graph") == 1 + 1 + 3
    assert all("consensus_gap_mean" in r and "mass_total" in r
               and "moved_mass" in r for r in recs if r["kind"] != "graph")
    assert all("t_round_s" in r for r in recs if r["kind"] == "round")
    assert all("t_window_s" in r for r in recs if r["kind"] == "tick")
    for r in recs:
        _close(r["mass_total"], 6.0)
    assert report.main([str(port_jsonl), "--check"]) == 0
    assert jreport.main([str(port_jsonl), "--check"]) == 0
    assert jreport.main([str(port_jsonl), "--graph"]) == 0
    out = capsys.readouterr().out
    assert "round" in out and "tick" in out and "report: OK" in out
    graph = [r for r in recs if r["kind"] == "graph"]
    assert all(f"mail_age{d}_mass" in graph[1] for d in range(1, 5))
    assert graph[-1]["n_active"] == 3


def test_reference_jsonl_passes_port_report(tmp_path, capsys):
    from repro.fl.simulator import SimConfig as JSimConfig
    from repro.fl.simulator import run_experiment as jrun
    from repro.spec import make_algo_spec as jmake
    spec = jmake("dfedpgp", n_neighbors=2, telemetry=True, graph_every=2)
    sim = JSimConfig(m=6, rounds=2, n_train=16, n_test=8, batch=8,
                     k_local=1, k_personal=1, spec=spec)
    p = tmp_path / "ref.jsonl"
    with jobs.JsonlSink(str(p)) as sink:
        jrun("dfedpgp", sim, eval_every=2, sink=sink)
    assert report.main([str(p), "--check"]) == 0
    assert report.main([str(p), "--graph"]) == 0
    assert "report: OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serve meter, percentile, phase timer, trace
# ---------------------------------------------------------------------------
def test_port_serve_meter_records_and_stats():
    ring = obs.RingSink()
    meter = ServeMeter(sink=ring, window=8, run="t")
    for i in range(10):
        meter.observe("fused", 64, 0.001 * (i + 1))
    meter.observe("naive", 64, 0.5)
    st = {(r["path"], r["batch"]): r for r in meter.stats()}
    assert st[("fused", 64)]["calls"] == 10
    assert st[("fused", 64)]["p50_ms"] == pytest.approx(6.0)
    assert st[("naive", 64)]["p50_ms"] == pytest.approx(500.0)
    recs = ring.records
    assert len(recs) == 11 and all(r["kind"] == "serve" for r in recs)
    for r in recs:
        record.validate(r)
        jobs.record.validate(r)
    assert recs[0]["rps"] == pytest.approx(64 / 0.001)
    assert len(meter.latencies("fused", 64)) == 8
    meter.clear("fused", 64)
    assert meter.latencies("fused", 64) == []
    assert {(r["path"], r["batch"]) for r in meter.stats()} == \
        {("naive", 64)}


def test_port_serve_meter_edge_cases_match_reference():
    from repro.serve import ServeMeter as JServeMeter
    lats = [0.002, 0.0, 0.003, 0.003, 0.003, 0.003, 0.001]
    tags = [("fused", 32), ("naive", 8), ("tie", 16), ("tie", 16),
            ("tie", 16), ("tie", 16), ("fused", 32)]
    t_ring, j_ring = obs.RingSink(), jobs.RingSink()
    tm = ServeMeter(sink=t_ring, window=4, run="t")
    jm = JServeMeter(sink=j_ring, window=4, run="t")
    for (path, b), s in zip(tags, lats):
        tm.observe(path, b, s)
        jm.observe(path, b, s)
    assert tm.stats() == jm.stats()
    assert t_ring.records == j_ring.records
    assert "rps" not in t_ring.records[1]
    tm.clear("fused", 32)
    jm.clear("fused", 32)
    assert tm.stats() == jm.stats()


def test_port_percentile_matches_reference():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    for q in (0, 1, 50, 90, 99, 100):
        assert report.percentile(xs, q) == jreport.percentile(xs, q)
    assert report.percentile([7.0], 99) == 7.0
    assert np.isnan(report.percentile([], 50))


def test_port_metered_servers_time_each_call():
    from repro_torch.models import cnn
    from repro_torch.serve import ServingState, make_cnn_server
    from repro_torch.serve import engine
    cfg = cnn.CNNConfig(widths=(4, 8), d_feature=16, gn_groups=2)
    from repro_torch.device import seeded_generator
    from repro_torch import tree
    params = cnn.init_params(seeded_generator(0, 1, 0), cfg, (3,))
    trunk = tree.tree_map(lambda a: a[0], {
        k: v for k, v in params.items() if k != "classifier"})
    sstate = ServingState(trunk, {"classifier": params["classifier"]})
    ring = obs.RingSink()
    meter = ServeMeter(sink=ring, run="t")
    fused = make_cnn_server(sstate, cfg, device="cpu", meter=meter)
    # full models that share the trunk, so both paths compute one function
    models = dict(tree.tree_map(lambda a: a.expand((3,) + a.shape), trunk),
                  classifier=params["classifier"])
    naive = engine.make_naive_server(models, cfg, meter=meter,
                                     device="cpu")
    plain = make_cnn_server(sstate, cfg, device="cpu")
    uid = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    x = torch.randn((4, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    out = fused(uid, x)
    assert torch.equal(out, plain(uid, x))
    ref = naive(uid, x)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert [(r["path"], r["batch"]) for r in ring.records] == \
        [("fused", 4), ("naive", 4)]


def test_port_phase_timer_accumulates_and_blocks():
    t = obs.PhaseTimer()
    for _ in range(2):
        with t.phase("round"):
            pass
    with t.phase("eval", block=True) as ph:
        ph.out = {"x": torch.ones(3)}
    g = t.gauges()
    assert set(g) == {"t_round_s", "t_eval_s"}
    assert t.seconds("round") == pytest.approx(g["t_round_s"], abs=1e-6)
    with t.phase("idle", block=True):
        pass
    assert t.seconds("idle") >= 0
    t.reset()
    assert t.gauges() == {}


def test_port_maybe_trace(tmp_path):
    with obs.maybe_trace(None):
        x = torch.ones(()) + 1
    assert float(x) == 2.0
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "trace"
    with obs.maybe_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "aten::mm" in files[0].read_text()
