"""The port's program invariant analyzer (`repro_torch.analysis`) held
against the JAX package on the CPU (the topology diagnostics,
`TopologySchedule` constructors and schedule checks it needs are
tests/test_torch_topology_diag.py, a file of its own so that pytest-xdist's
`--dist loadfile` spreads the two).

- Programs: each of the six registered programs is built from the
  reference's draws (its quad targets, tables, active sets, serve init
  and requests: torch cannot replay `jax.random`) and its N_ROUNDS
  rounds end equal to the reference program's, at the tolerance the
  engine's existing port test uses: the resident and sampled rounds and
  Regime B rtol 1e-4 / atol 2e-5 (tests/test_torch_dfedpgp.py,
  test_torch_sampling.py, test_torch_regime_b.py), the async tick rtol
  1e-5 / atol 1e-6 (tests/test_torch_async.py), the serve logits rtol /
  atol 2e-5 (tests/test_torch_serve.py); mu exact.  Every stateful
  program must move its state by more than 1e-3.  The reference's
  Regime B programs take m from the jax device count (1 here), so their
  counterparts are its `launch.steps.build_step` at the port's m 13 on
  one CPU device, the same arguments its builder passes, from the
  reference's own init on random tokens (its builder's all-zero state and
  batches make every gradient and mix 0).  Measured with jax 0.9.0 and
  torch 2.13 on the CPU: the buffer moves by up to 7.37 (resident) and
  4.25 (sampled) over the 3 rounds, the worst leaf gap 5.8e-6 and 4.5e-6;
  a port round whose mix returns its input fails (flat off by 1.1).
- Detectors: every shipped program is clean, every broken fixture trips
  its own detector, and the detector mechanics (scopes, vmap, m 1, n/a,
  the report, the CLI's exit codes) hold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import programs as jprograms
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_reduced as jget_reduced
from repro.core import topology as jtopology
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import detectors, fixtures, programs, scope
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import topology as ttopology

torch.set_num_threads(2)
M = programs.SIM_M
TOL = {"simA.resident": (1e-4, 2e-5), "simA.sampled": (1e-4, 2e-5),
       "regimeB.resident": (1e-4, 2e-5), "regimeB.sampled": (1e-4, 2e-5),
       "async.tick": (1e-5, 1e-6), "serve.cnn": (2e-5, 2e-5)}


def _t_topo(P):
    return ttopology.SparseTopology(torch.tensor(np.asarray(P.idx)),
                                    torch.tensor(np.asarray(P.w)))


# ---------------------------------------------------------------------------
# the six programs against the reference's
# ---------------------------------------------------------------------------
def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _ref_active(seed, m, n_act):
    return [np.asarray(jnp.sort(jax.random.permutation(
        jax.random.fold_in(jax.random.PRNGKey(seed), t), m)[:n_act])
        .astype(jnp.int32)) for t in range(programs.N_ROUNDS)]


def _ref_tables(sched):
    return [(np.asarray(sched.at(t).idx), np.asarray(sched.at(t).w))
            for t in range(programs.N_ROUNDS)]


def _run_reference(inst):
    """N_ROUNDS rounds of a reference ProgramInstance -> last output."""
    jitted = jax.jit(inst.fn, donate_argnums=inst.donate)
    carry, out = None, None
    for t in range(programs.N_ROUNDS):
        out = jitted(*inst.args(t, carry))
        carry = inst.carry_of(out)
    return out


def _run_port(inst):
    carry, out = None, None
    for t in range(programs.N_ROUNDS):
        out = inst.fn(*inst.args(t, carry))
        carry = inst.carry_of(out)
    return out


def _regime_b_reference(sampled):
    """The reference's Regime B program at m 13 on one device: its
    builder's arguments with the port's client count, started from its
    own init (not the builder's zeros, under which every gradient and
    mix is 0) on random token batches."""
    cfg = jget_reduced("qwen2-0.5b")
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=16,
                                global_batch=M)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    layout = jsteps.Layout(("data",), (), ("model",), (), M, 1)
    sched = jtopology.TopologySchedule.random(M, 2, seed=7)
    kw = dict(resident=True, schedule=sched)
    algo, _, _, flat_layout = jsteps.build_train_algo(cfg, mesh, layout,
                                                      **kw)
    if sampled:
        kw["sample_frac"] = 0.5
    fn, _, _, structs, donate = jsteps.build_step(cfg, mesh, layout, shape,
                                                  **kw)
    api = jget_model(cfg)
    init = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), M))
    state0, _ = algo.init_flat(init, flat_layout)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(programs.N_ROUNDS):
        toks = {k: rng.integers(0, cfg.vocab, size=s["tokens"].shape)
                .astype(np.int32) for k, s in structs[-1].items()}
        batches.append({k: {"tokens": t, "labels": np.roll(t, -1, -1)}
                        for k, t in toks.items()})
    active = None
    if sampled:
        active = _ref_active(11, M, structs[2].shape[0])
        rest = tuple((jtopology.induced_subgraph(sched.at(t),
                                                 jnp.asarray(a), "row"),
                      jnp.asarray(a), jax.tree.map(jnp.asarray, b))
                     for t, (a, b) in enumerate(zip(active, batches)))
    else:
        rest = tuple((sched.at(t), jax.tree.map(jnp.asarray, b))
                     for t, b in enumerate(batches))
    inst = jprograms.ProgramInstance(
        name="ref", fn=fn, round_args=rest,
        fresh_state=lambda: jax.tree.map(jnp.copy, state0),
        donate=donate, m=M)
    state = convert.flat_state_from_reference(
        flat=np.asarray(state0.flat),
        personal=_np_tree(state0.personal), mu=np.asarray(state0.mu),
        mom_u=np.asarray(state0.opt_u.momentum),
        mom_v=_np_tree(state0.opt_v.momentum),
        round=np.asarray(state0.round))
    return inst, dict(tables=_ref_tables(sched), active=active,
                      state=state, batches=batches)


def _serve_reference():
    """The reference's serve.cnn builder (`build_serve_cnn`) on its
    draws, its head on the plain path (force="ref", the path the port
    takes on the CPU; its default interprets the Pallas kernel), and the
    port's on those draws."""
    from repro import serve as jserve
    from repro.core import dfedpgp as jdfedpgp
    from repro.core import partition as jpartition
    from repro.models import cnn as jcnn
    from repro.optim import SGD as JSGD

    cfg = jcnn.CNNConfig(image_size=8, n_classes=10)
    # the builder's draws, jitted (eager draws compile op by op)
    template = jax.jit(lambda k: jcnn.init_params(k, cfg))(
        jax.random.PRNGKey(0))
    mask = jpartition.build_mask(template, jpartition.classifier_personal)
    algo = jdfedpgp.DFedPGP(loss_fn=lambda p, b: jcnn.loss_fn(p, b, cfg),
                            mask=mask, opt_u=JSGD(lr=0.1),
                            opt_v=JSGD(lr=0.1))
    init = jax.jit(jax.vmap(lambda k: jcnn.init_params(k, cfg)))(
        jax.random.split(jax.random.PRNGKey(1), M))
    state, layout = algo.init_flat(init)
    sstate = jserve.from_train_state(state, layout=layout, consensus="mass")

    @jax.jit
    def request(t):
        ku, kx = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(2), t))
        return (jax.random.randint(ku, (6,), 0, M, jnp.int32),
                jax.random.normal(kx, (6, 8, 8, 3)))

    requests = tuple(request(t) for t in range(programs.N_ROUNDS))
    jinst = jprograms.ProgramInstance(
        name="ref", fn=lambda uid, x: jserve.serve_logits(
            sstate, uid, x, cfg, force="ref"),
        round_args=requests, fresh_state=None, donate=(), m=M)
    return jinst, programs.build_serve_cnn(
        "cpu", init=convert.params_from_reference(_np_tree(init)),
        requests=[tuple(np.asarray(a) for a in r) for r in requests])


def _pair(name):
    """(reference instance, port instance) on the reference's draws."""
    if name.startswith("regimeB"):
        sampled = name.endswith("sampled")
        jinst, kw = _regime_b_reference(sampled)
        if not sampled:
            kw.pop("active")
        return jinst, programs.PROGRAMS[name](device="cpu", **kw)
    if name == "serve.cnn":
        return _serve_reference()
    _, cu, cv = jprograms._quad_setup()
    kw = dict(cu=np.asarray(cu), cv=np.asarray(cv), tables=_ref_tables(
        jtopology.TopologySchedule.random(M, 3, seed=13)))
    if name == "simA.sampled":
        kw["active"] = _ref_active(101, M, 7)
    builder = {"simA.resident": jprograms.build_sim_resident,
               "simA.sampled": jprograms.build_sim_sampled,
               "async.tick": jprograms.build_async_tick}[name]
    return builder(), programs.PROGRAMS[name](device="cpu", **kw)


def _state_leaves(x, prefix=""):
    """{path: numpy} over a state's array leaves (NamedTuples, dicts)."""
    if x is None:
        return {}
    if hasattr(x, "_fields"):
        out = {}
        for f in x._fields:
            out.update(_state_leaves(getattr(x, f), f"{prefix}{f}/"))
        return out
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(_state_leaves(x[k], f"{prefix}{k}/"))
        return out
    if isinstance(x, torch.Tensor):
        return {prefix.rstrip("/"): x.detach().double().numpy()}
    if isinstance(x, (int, float)):
        return {prefix.rstrip("/"): np.asarray(x, np.float64)}
    return {prefix.rstrip("/"): np.asarray(x, np.float64)}


@pytest.mark.parametrize("name", list(programs.PROGRAMS))
def test_program_matches_reference(name):
    jinst, tinst = _pair(name)
    start = (_state_leaves(tinst.fresh_state())
             if tinst.fresh_state is not None else {})
    want, got = _run_reference(jinst), _run_port(tinst)
    rtol, atol = TOL[name]
    if name == "serve.cnn":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)
        return
    w, g = _state_leaves(want[0]), _state_leaves(got[0])
    if name == "async.tick":
        # the reference's clock tick is a device array, the port's a host
        # int; both are compared below
        w.pop("clock/t"), g.pop("clock/t")
        assert got[0].clock.t == int(want[0].clock.t) == programs.N_ROUNDS
    w = {k: v for k, v in w.items() if k in g or v.ndim > 1}
    assert set(g) == set(w), set(g) ^ set(w)
    for k in g:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(got[0].mu.numpy(), np.asarray(want[0].mu))
    # the rounds did work: the shared buffer (or the params) moved
    moved = max(float(np.abs(g[k] - start[k]).max()) for k in g
                if k in start and g[k].shape == start[k].shape)
    assert moved > 1e-3, moved


# ---------------------------------------------------------------------------
# the shipped programs pass every detector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(programs.PROGRAMS))
def test_program_clean(name):
    row, viols = detectors.run_program(programs.PROGRAMS[name](device="cpu"))
    assert not viols, viols
    assert row["program"] == name and row["m"] == M
    assert "FAIL" not in row.values()
    assert row["donation"] == ("n/a" if name in ("async.tick", "serve.cnn")
                               else "ok")


def test_hostsync_finds_the_per_round_lr_upload(monkeypatch):
    # before the fix, _lr_scale made its decay base with torch.tensor every
    # round: the detector names it
    def per_round(self, rnd):
        return torch.tensor(self.lr_decay, dtype=torch.float32,
                            device=rnd.device) ** rnd.to(torch.float32)

    inst = programs.build_sim_resident("cpu")
    before = _run_port(inst)[0]
    monkeypatch.setattr(tdfedpgp.DFedPGP, "_lr_scale", per_round)
    msgs = detectors.check_host_sync(inst)
    assert len(msgs) == 1 and "aten.lift_fresh" in msgs[0], msgs
    # the base filled on the device gives the per-round values bit for bit
    after = _run_port(inst)[0]
    assert torch.equal(before.flat, after.flat)
    assert torch.equal(before.opt_u.momentum, after.opt_u.momentum)


def test_async_allowlists_name_only_their_sites():
    # stripped of its reviewed scopes, the tick trips exactly there
    inst = dataclasses.replace(programs.build_async_tick("cpu"),
                               allow_sync=(), allow_vary=())
    run = detectors.drive(inst)
    msgs = detectors.check_host_sync(inst, run)
    scopes = {m.split("at scope '")[1].rstrip("'") for m in msgs}
    assert scopes == {"async.fire_gate", "async.host_clock", "obs.to_host"}
    assert detectors.check_retrace(inst, run)
    assert not detectors.check_retrace(
        dataclasses.replace(inst, allow_vary=(programs.HOST_CLOCK,
                                              programs.FIRE)), run)


# ---------------------------------------------------------------------------
# each broken fixture trips the detector it targets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(fixtures.FIXTURES))
def test_fixture_trips_its_detector(name):
    _, expected = fixtures.FIXTURES[name]
    _, viols = fixtures.run_fixture(name, device="cpu")
    assert viols, f"fixture {name} did not trip anything"
    assert set(expected) <= {v.detector for v in viols}, (expected, viols)


def test_retrace_fixture_caught_with_count():
    _, viols = fixtures.run_fixture("retrace", device="cpu")
    assert any(v.detector == "retrace" and "2 distinct op signatures" in
               v.message and "0.9801" in v.message for v in viols), viols


def test_donation_fixture_names_the_holding_output():
    _, viols = fixtures.run_fixture("donation", device="cpu")
    assert len(viols) == 1 and "first_row" in viols[0].message, viols


def test_donation_catches_a_moved_inplace_leaf():
    def fn(U, b):
        return U + b, torch.sum(U)       # a new buffer, not written in place

    inst = programs.ProgramInstance(
        name="t", fn=fn, round_args=((torch.ones(M, 4),),) * 3,
        fresh_state=lambda: torch.ones(M, 4), donate=(0,), m=M,
        inplace=("",))
    msgs = detectors.check_donation(inst)
    assert msgs and "moved" in msgs[0], msgs


def test_donation_gates_requested_not_allocated_bytes():
    # the (memory_allocated, requested) readings of chip_smoke.py's phase
    # `analysis` on an NVIDIA H100 80GB HBM3 (700.00 W): regimeB.resident,
    # where blocks handed out unsplit move memory_allocated alone, and a
    # state chaining an autograd graph across rounds, which grows both
    inst = programs.build_sim_resident("cpu")
    run = detectors.drive(inst)
    assert run.memory == []          # the CPU has no caching allocator
    flat = run._replace(memory=[(142_507_008, 142_342_680),
                                (142_584_832, 142_342_680),
                                (142_507_008, 142_342_680)])
    assert not detectors.check_donation(inst, flat)
    # (round 0 is not gated: it is given round 1's reading)
    chained = run._replace(memory=[(80_740_864, 80_740_356),
                                   (80_740_864, 80_740_356),
                                   (84_148_736, 84_148_228)])
    msgs = detectors.check_donation(inst, chained)
    assert len(msgs) == 1 and "[80740356, 84148228] requested" in msgs[0]


# ---------------------------------------------------------------------------
# detector mechanics
# ---------------------------------------------------------------------------
def test_densify_allowlist_by_scope():
    P = ttopology.TopologySchedule.random(M, 3, seed=3).at(0)

    def fn(U, P):
        with scope.scope("diag_dense"):
            dense = P.dense()
        return dense @ U, torch.sum(U)

    def inst(allow):
        return programs.ProgramInstance(
            name="t", fn=fn, round_args=((P,),) * programs.N_ROUNDS,
            fresh_state=lambda: torch.ones((M, 4)), donate=(0,), m=M,
            allow_dense=allow)

    assert detectors.check_densify(inst(()))            # flagged bare...
    assert not detectors.check_densify(inst(("diag_dense",)))  # ...waived


def test_densify_sees_ops_inside_vmap():
    # an (m, m) intermediate of one client's gradient, batched by vmap
    def per_client(p, t):
        return torch.sum((torch.outer(p, p) - t) ** 2)

    def fn(U, T):
        g = torch.func.vmap(torch.func.grad(per_client))(U, T)
        return U - 0.1 * g, torch.sum(U)

    inst = programs.ProgramInstance(
        name="t", fn=fn, round_args=((torch.zeros(M, M, M),),) * 3,
        fresh_state=lambda: torch.ones((M, M)), donate=(0,), m=M)
    msgs = detectors.check_densify(inst)
    assert any(f"({M}, {M}, {M})" in m for m in msgs), msgs


def test_densify_vacuous_at_m_one():
    inst = programs.ProgramInstance(
        name="t", fn=lambda U: (U + 1.0, torch.sum(U)),
        round_args=((),) * programs.N_ROUNDS,
        fresh_state=lambda: torch.ones((1, 1)), donate=(0,), m=1)
    assert detectors.check_densify(inst) == []


def test_donation_na_for_stateless_programs():
    row, viols = detectors.run_program(programs.build_serve_cnn("cpu"))
    assert row["donation"] == "n/a"
    assert not viols


def test_run_all_api_shape():
    rows, srows, viols = detectors.run_all(names=("simA.resident",),
                                           device="cpu")
    assert not viols
    assert len(rows) == 1 and len(srows) == 5


def test_report_renders_fail_rows():
    rows = [{"program": "p", "m": 13, "densify": "FAIL"}]
    v = [detectors.Violation("p", "densify", "boom")]
    out = detectors.render_report(rows, [], v)
    assert "FAIL" in out and "boom" in out and "program invariants" in out


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_exit_codes_on_the_cpu(capsys):
    assert cli.main(["--list"]) == 0
    assert cli.main(["--program", "nope", "--device", "cpu"]) == 2
    for name in fixtures.FIXTURES:
        assert cli.main(["--fixture", name, "--device", "cpu"]) == 1, name
    assert "tripped as intended" in capsys.readouterr().out


def test_cli_all_on_the_cpu(capsys):
    assert cli.main(["--all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all invariants hold" in out
    assert all(name in out for name in programs.PROGRAMS)


def test_cli_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--program", "simA.resident"])
