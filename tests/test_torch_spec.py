"""Port parity of the one knob surface (`repro_torch.spec`,
`repro_torch.fl.compat`) against the reference's (`repro.spec`,
`repro.fl.compat`): the counterparts of tests/test_spec.py's Regime-A
cases.

One stated difference: `block_m` is the reference's Pallas DMA-panel
knob, allowed with gossip="pallas".  The port's kernels take block_d /
block_n, so the port refuses block_m with every gossip mode and names
those knobs (`test_block_m_refused_and_names_port_knobs`)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import spec as jspec
from repro_torch import compress, tree
from repro_torch.core import sampling, topology
from repro_torch.fl import compat
from repro_torch.fl import simulator
from repro_torch.spec import GOSSIP_MODES, UNDIRECTED_ALGOS, make_algo_spec

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# factory validation
# ---------------------------------------------------------------------------
def test_port_factory_defaults_and_alias():
    sp = make_algo_spec()
    assert sp.algo == "dfedpgp" and sp.gossip == "sparse" and sp.resident
    assert make_algo_spec(gossip="matrix").gossip == "sparse"
    assert isinstance(hash(sp), int)
    with pytest.raises(dataclasses.FrozenInstanceError):
        sp.gossip = "dense"
    # the reference's field set, defaults and constants
    jf = {f.name: f.default for f in dataclasses.fields(jspec.AlgoSpec)}
    tf = {f.name: f.default for f in dataclasses.fields(type(sp))}
    assert tf == jf
    assert GOSSIP_MODES == jspec.GOSSIP_MODES
    assert UNDIRECTED_ALGOS == jspec.UNDIRECTED_ALGOS


INVALID = [
    (dict(topology="torus"), "topology"),
    (dict(gossip="carrier-pigeon"), "gossip"),
    (dict(codec="zip"), "codec"),
    (dict(participation="sometimes"), "participation"),
    (dict(participation_frac=0.5), "participation_frac"),
    (dict(participation="uniform", participation_frac=1.5), "frac"),
    (dict(gossip="ppermute", codec="topk"), "mutually exclusive"),
    (dict(gossip="ppermute", participation="uniform",
          participation_frac=0.5), "ppermute"),
    (dict(codec="topk", resident=False), "resident"),
    (dict(telemetry=True, resident=False), "telemetry"),
    (dict(graph_every=-1, telemetry=True), "graph_every"),
    (dict(graph_every=4), "telemetry"),
]


@pytest.mark.parametrize("kw,msg", INVALID)
def test_port_factory_rejects_invalid_like_reference(kw, msg):
    with pytest.raises(ValueError, match=msg):
        make_algo_spec(**kw)
    with pytest.raises(ValueError, match=msg):
        jspec.make_algo_spec(**kw)


VALID = [
    dict(),
    dict(topology="ring", gossip="dense"),
    dict(gossip="pallas", codec="topk", codec_gamma="auto"),
    dict(codec="qsgd", codec_bits=8),
    dict(participation="uniform", participation_frac=0.25),
    dict(participation="trace", participation_frac=0.5),
    dict(gossip="ppermute"),
    dict(telemetry=True, graph_every=2),
    dict(topology="exponential", seed=3, n_neighbors=4),
]


@pytest.mark.parametrize("kw", VALID)
def test_port_factory_accepts_what_reference_accepts(kw):
    tp, jp = make_algo_spec("osgp", **kw), jspec.make_algo_spec("osgp", **kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("gossip", ["sparse", "dense", "pallas"])
def test_block_m_refused_and_names_port_knobs(gossip):
    """The one difference from tests/test_spec.py:57: the reference
    accepts block_m with gossip='pallas'; the port refuses it always."""
    if gossip == "pallas":
        assert jspec.make_algo_spec(gossip="pallas",
                                    block_m=128).block_m == 128
    with pytest.raises(ValueError, match="block_m") as err:
        make_algo_spec(gossip=gossip, block_m=128)
    assert "block_d" in str(err.value) and "block_n" in str(err.value)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------
def test_port_get_schedule_registry():
    s1 = topology.get_schedule("random", 8, 3, seed=4)
    s2 = topology.get_schedule("random", 8, 3, seed=4)
    assert s1 == s2
    assert torch.equal(s1.at(2).idx, s2.at(2).idx)
    assert topology.get_schedule("ring", 8, 3, seed=9) \
        == topology.get_schedule("ring", 8, 5, seed=1)
    with pytest.raises(ValueError, match="schedule kind"):
        topology.get_schedule("torus", 8)


@pytest.mark.parametrize("kind,m", [("random", 8), ("undirected", 8),
                                    ("exponential", 16), ("ring", 8),
                                    ("full", 8)])
def test_schedule_period_matches_reference(kind, m):
    from repro.core import topology as jtopology
    t = topology.get_schedule(kind, m, 3, 0)
    j = jtopology.get_schedule(kind, m, 3, 0)
    assert t.period == j.period


def test_port_get_sampler_registry():
    assert sampling.get_sampler("full", 8) is None
    s = sampling.get_sampler("uniform", 8, frac=0.5, seed=3)
    assert s.n_active == 4
    with pytest.raises(ValueError, match="participation_frac"):
        sampling.get_sampler("full", 8, frac=0.5)
    with pytest.raises(ValueError, match="participation kind"):
        sampling.get_sampler("lottery", 8)


def test_port_get_codec_registry():
    assert compress.get_codec(None) is None
    assert isinstance(compress.get_codec("topk", ratio=0.25),
                      compress.TopKCodec)
    assert compress.get_codec("qsgd", bits=8).bits == 8
    with pytest.raises(ValueError, match="codec kind"):
        compress.get_codec("zip")


def test_port_spec_resolution_methods():
    sp = make_algo_spec("dfedpgp", topology="ring", codec="topk",
                        codec_ratio=0.25, participation="uniform",
                        participation_frac=0.5, seed=3)
    assert sp.schedule(8).kind == "ring"
    assert sp.make_codec().ratio == 0.25
    assert sp.sampler(8).n_active == 4
    assert make_algo_spec("dfedavgm").schedule(8).kind == "undirected"
    # the same draws as the reference's sampler (a numpy stream)
    jsp = jspec.make_algo_spec("dfedpgp", participation="uniform",
                               participation_frac=0.5, seed=3)
    for t in range(5):
        np.testing.assert_array_equal(np.asarray(sp.sampler(8).active_at(t)),
                                      np.asarray(jsp.sampler(8).active_at(t)))


# ---------------------------------------------------------------------------
# SimConfig(spec=...) == the legacy knob surface
# ---------------------------------------------------------------------------
LEGACY = simulator.SimConfig(m=6, rounds=2, n_neighbors=2, n_train=16,
                             n_test=8, batch=8, k_local=2, k_personal=1,
                             topology="ring", gossip="dense")


def _with_spec(sp, **over):
    """LEGACY with every spec-owned knob reset to its SimConfig default."""
    defaults = {f.name: f.default
                for f in dataclasses.fields(simulator.SimConfig)}
    reset = {k: defaults[k] for k in simulator._SPEC_KNOBS}
    return dataclasses.replace(LEGACY, spec=sp, **{**reset, **over})


def test_port_spec_knobs_match_reference():
    from repro.fl import simulator as jsim
    assert simulator._SPEC_KNOBS == jsim._SPEC_KNOBS


def test_port_simconfig_spec_bitwise_equals_legacy():
    h_old = simulator.run_experiment("dfedpgp", LEGACY, eval_every=1,
                                     return_params=True, device="cpu")
    sp = make_algo_spec("dfedpgp", topology="ring", gossip="dense",
                        n_neighbors=2, seed=LEGACY.seed)
    h_new = simulator.run_experiment("dfedpgp", _with_spec(sp), eval_every=1,
                                     return_params=True, device="cpu")
    assert h_old["final_acc"] == h_new["final_acc"]
    assert h_old["wire_bytes"] == h_new["wire_bytes"]
    for path, leaf in tree.paths(h_old["params"]):
        assert torch.equal(leaf, tree.get(h_new["params"], path)), path


def test_port_simconfig_spec_conflict_raises():
    sp = make_algo_spec("dfedpgp", n_neighbors=2)
    with pytest.raises(ValueError, match="conflicts with legacy"):
        simulator.run_experiment(
            "dfedpgp", dataclasses.replace(LEGACY, spec=sp), eval_every=1,
            device="cpu")
    with pytest.raises(ValueError, match="one spec"):
        simulator.run_experiment("osgp", _with_spec(sp), eval_every=1,
                                 device="cpu")


def test_port_regime_a_rejects_ppermute():
    sp = make_algo_spec("dfedpgp", gossip="ppermute", n_neighbors=2)
    with pytest.raises(ValueError, match="ppermute"):
        simulator.run_experiment("dfedpgp", _with_spec(sp), eval_every=1,
                                 device="cpu")


def test_spec_from_sim_matches_reference():
    from repro.fl import compat as jcompat
    from repro.fl import simulator as jsim
    for over in (dict(), dict(codec="topk", codec_gamma=0.5),
                 dict(participation="uniform", participation_frac=0.5)):
        tsim = dataclasses.replace(LEGACY, **over)
        jsim_cfg = jsim.SimConfig(**{f.name: getattr(tsim, f.name)
                                     for f in dataclasses.fields(tsim)
                                     if f.name != "spec"})
        assert dataclasses.asdict(compat.spec_from_sim(tsim, "osgp")) == \
            dataclasses.asdict(jcompat.spec_from_sim(jsim_cfg, "osgp"))


# ---------------------------------------------------------------------------
# deprecated surface: importable, warns, still correct
# ---------------------------------------------------------------------------
def test_port_deprecated_helpers_warn_and_work():
    sim = dataclasses.replace(LEGACY, codec="topk")
    for name, args in (("make_schedule", ("dfedpgp", sim)),
                       ("make_sim_codec", (sim,)),
                       ("make_sampler", (sim,))):
        fn = getattr(simulator, name)
        with pytest.warns(DeprecationWarning, match="deprecated"):
            out = fn(*args)
        if name == "make_schedule":
            assert out.kind == "ring"
        elif name == "make_sim_codec":
            assert isinstance(out, compress.TopKCodec)
        else:
            assert out is None
    trace = dataclasses.replace(LEGACY, participation="trace",
                                participation_frac=0.5, hetero="tiered")
    with pytest.warns(DeprecationWarning):
        s = simulator.make_sampler(trace)
    assert s.n_active == 3
    with pytest.raises(AttributeError):
        simulator.no_such_helper


# ---------------------------------------------------------------------------
# a spec round == the legacy round
# ---------------------------------------------------------------------------
def test_port_spec_round_bitwise_equals_legacy_round():
    """One resident round built from the spec surface equals the round
    built from the legacy knobs bit for bit (same schedule, same init),
    and a telemetry spec leaves that round's state unchanged."""
    from repro_torch.data import make_dataset, sample_batches
    from repro_torch.device import seeded_generator
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(widths=(4, 8), d_feature=16, gn_groups=2)
    m = 8
    legacy = simulator.SimConfig(m=m, n_neighbors=2, topology="exponential",
                                 k_local=2, k_personal=1, batch=8)
    sp = make_algo_spec("dfedpgp", topology="exponential", n_neighbors=2)
    spec_sim = _with_spec(sp, m=m, k_local=2, k_personal=1, batch=8)
    data = make_dataset(0, m, n_train=16, n_test=8, device="cpu")
    init = cnn.init_params(seeded_generator(0, 1, 0), cfg, (m,))
    from repro_torch.core import partition
    mask = partition.build_mask(init, partition.classifier_personal)

    def loss_fn(p, b):
        return cnn.loss_fn(p, b, cfg)

    def one_round(sim, telemetry=False):
        spr = simulator.resolve_spec("dfedpgp", sim)
        view = simulator._spec_view(sim, spr)
        algo = simulator.build_algorithm("dfedpgp", loss_fn, mask, view,
                                         spr.make_codec(),
                                         telemetry=telemetry)
        state, layout = algo.init_flat(init, device="cpu")
        b = sample_batches(seeded_generator(0, 2, 0), data, 3, 8)
        b = {"v": {k: a[:, :1] for k, a in b.items()},
             "u": {k: a[:, 1:] for k, a in b.items()}}
        return algo.round_fn_flat(state, spr.schedule(m).at(0), b, layout)

    s_leg, m_leg = one_round(legacy)
    s_spec, m_spec = one_round(spec_sim)
    s_tel, m_tel = one_round(spec_sim, telemetry=True)
    for s in (s_spec, s_tel):
        assert torch.equal(s.flat, s_leg.flat)
        assert torch.equal(s.mu, s_leg.mu)
        assert torch.equal(s.opt_u.momentum, s_leg.opt_u.momentum)
    assert float(m_spec["loss_u"]) == float(m_leg["loss_u"])
    assert "consensus_gap_mean" in m_tel and "consensus_gap_mean" not in \
        m_spec
