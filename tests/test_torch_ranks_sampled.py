"""The sampled round and the round gauges across ranks (`launch.ranks`
`compact_bounds` / `gather_plan` over explicit bounds,
`launch.steps.make_matrix_mix_sampled` and `RankRound`,
`DFedPGP.round_fn_sampled(across_ranks=...)`, `obs.gauges.*_ranks`,
`obs.graph.emit_graph_record(ranks=...)`, `train.py --ranks --sample
--telemetry`) against the JAX reference.

The gloo group runs in a subprocess of `python -m
repro_torch.launch.ranks_check --device cpu` (two ranks here; four in
tests/test_torch_ranks_sampled_tp.py), so the children never import this
file.  The reference's one-device rounds (`build_train_algo(cfg, None,
layout, spec=...)`, jitted on one CPU device, as
tests/test_torch_regime_b.py runs them; its 8-device tests fail on jax
0.9.0) are the oracle, on the same init, batches, active sets and
induced tables:
- the plans: `compact_bounds` against searchsorted, `gather_plan` over
  unequal bounds and with a rank that owns nothing (every pair of ranks
  agrees on what crosses), and over equal bounds the plans of the
  equal-block formula the resident mix has always planned with;
- 3 sampled rounds of reduced() qwen2-0.5b at W 2 (m 8, frac 0.5, the
  reference sampler's actives, k 3 < n_act 4: the reference's mix
  gathers): every state leaf at the Regime B tolerance (rtol 1e-4, atol
  2e-5), mu bit for bit, the dormant rows of every round bit for bit;
- their metrics and gauges, and those of 3 resident rounds, against the
  reference's records at rtol 1e-5, atol 1e-6, with telemetry on bit for
  bit the state of telemetry off;
- a collaboration-graph record of the sampled state against the port's
  one-device record of the same arrays and draws (which
  tests/test_torch_obs_graph.py holds against the reference);
- `train.main(["--ranks", "2", "--sample", "0.5", "--telemetry", ...])`:
  its round records equal the one-rank run's."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch import tree
from repro_torch.core import topology as ttopology
from repro_torch.launch import ranks as tranks
from repro_torch.launch import train as ttrain
from repro_torch.obs import graph as tgraph
from repro_torch.obs import record as trecord
from repro_torch.obs import sink as tsink
from repro_torch.spec import make_algo_spec as tmake_spec

SRC = str(Path(__file__).resolve().parent.parent / "src")
RTOL, ATOL = 1e-4, 2e-5                  # the Regime B rounds
G_RTOL, G_ATOL = 1e-5, 1e-6              # the round gauges
M, B, S, ROUNDS, N_NB = 8, 2, 16, 3, 2   # k = N_NB + 1 = 3
TIMEOUT = 300
GRAPH_SEED = 3
ODD = dict(d_model=127, head_dim=32, vocab=257)   # d_flat odd


# ---------------------------------------------------------------------------
# the plans (pure functions)
# ---------------------------------------------------------------------------
def _equal_block_plan(idx, m, world, rank):
    """The equal-block plan the resident matrix mix has planned with:
    rank q holds rows [q n, (q + 1) n), row g lives on g // n."""
    n = m // world
    lo, hi = rank * n, (rank + 1) * n

    def needs(rows, a, b):
        return tuple(sorted({int(g) for row in rows for g in row}
                            - set(range(a, b))))

    halo = needs(idx[lo:hi], lo, hi)
    recv = tuple((q, tuple(g for g in halo if g // n == q))
                 for q in range(world) if q != rank
                 and any(g // n == q for g in halo))
    send = []
    for q in range(world):
        if q == rank:
            continue
        want = tuple(g for g in needs(idx[q * n:(q + 1) * n], q * n,
                                      (q + 1) * n) if lo <= g < hi)
        if want:
            send.append((q, want))
    return tranks.GatherPlan(lo, hi, halo, recv, tuple(send))


@pytest.mark.parametrize("m,world", [(8, 1), (8, 2), (8, 4), (12, 3),
                                     (16, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equal_bounds_give_the_equal_block_plans_exactly(m, world, seed):
    idx = ttopology.get_schedule("random", m, 3, seed).at(seed).idx.tolist()
    for r in range(world):
        want = _equal_block_plan(idx, m, world, r)
        assert tranks.gather_plan(idx, m, world, r) == want
        assert tranks.gather_plan(idx, m, world, r,
                                  tranks.equal_bounds(m, world)) == want


@pytest.mark.parametrize("active,world,want", [
    ([0, 1, 2, 3], 4, (0, 2, 4, 4, 4)),
    ([0, 1, 6, 7], 4, (0, 2, 2, 2, 4)),
    ([1, 2, 3, 5], 4, (0, 1, 3, 4, 4)),
    ([4, 5, 6, 7], 2, (0, 0, 4)),
    ([3], 2, (0, 1, 1)),
    ([0, 2, 4, 6], 1, (0, 4))])
def test_compact_bounds_are_searchsorted(active, world, want):
    got = tranks.compact_bounds(active, 8, world)
    assert got == want
    blocks = np.arange(world + 1) * 8 // world
    assert got == tuple(np.searchsorted(active, blocks[:-1])) + (
        len(active),)


def test_compact_bounds_want_sorted_unique_ids():
    with pytest.raises(ValueError, match="sorted, unique"):
        tranks.compact_bounds([3, 1], 8, 2)
    with pytest.raises(ValueError, match="sorted, unique"):
        tranks.compact_bounds([1, 1], 8, 2)


@pytest.mark.parametrize("bounds", [(0, 2, 2, 5, 6), (0, 0, 3, 3, 6),
                                    (0, 6, 6, 6, 6), (0, 1, 2, 3, 6)])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_plan_over_unequal_bounds_pairs_up(bounds, seed):
    # a compact table of 6 rows over 4 ranks that own unequally, some
    # none: every row a rank reads is its own or received from its owner,
    # who sends exactly it
    rng = np.random.default_rng(seed)
    n, world = 6, 4
    idx = [[i] + sorted(rng.choice([g for g in range(n) if g != i], 2,
                                   replace=False).tolist())
           for i in range(n)]
    plans = [tranks.gather_plan(idx, n, world, r, bounds)
             for r in range(world)]
    for r, plan in enumerate(plans):
        lo, hi = bounds[r], bounds[r + 1]
        assert (plan.lo, plan.hi) == (lo, hi)
        reads = {g for row in idx[lo:hi] for g in row}
        assert set(plan.halo) == reads - set(range(lo, hi))
        for q, rows in plan.recv:
            assert all(bounds[q] <= g < bounds[q + 1] for g in rows)
            assert dict(plans[q].send)[r] == rows
        for q, rows in plan.send:
            assert dict(plans[q].recv)[r] == rows
        positions = sorted(plan.position(g) for g in
                           set(range(lo, hi)) | reads)
        assert positions == list(range(hi - lo + len(plan.halo)))
        if lo == hi:
            assert plan.halo == () and plan.recv == ()


@pytest.mark.parametrize("bounds", [(0, 2, 5), (0, 4, 4, 4), (0, 1, 1, 2)])
def test_gather_plan_refuses_bad_bounds(bounds):
    idx = [[0, 1]] * 4
    with pytest.raises(ValueError, match="ascending row bounds"):
        tranks.gather_plan(idx, 4, 2, 0, bounds)


# ---------------------------------------------------------------------------
# the reference's one-device rounds
# ---------------------------------------------------------------------------
def _jcfg(replace):
    return jget_reduced("qwen2-0.5b").replace(compute_dtype="float32",
                                              **dict(replace))


def flat_paths(tree_, prefix):
    return {prefix + "/" + "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                   k)))
                                    for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree_)[0]}


@functools.lru_cache(maxsize=None)
def _reference_algo(m, sampled, replace=()):
    """The reference's one-device resident algo with telemetry, its jitted
    round (sampled or resident) and the initial state of m clients."""
    cfg = _jcfg(replace)
    spec = jmake_spec("dfedpgp", topology="random", n_neighbors=N_NB,
                      seed=0, gossip="matrix", resident=True,
                      telemetry=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), m, B)
    algo, _, _, fl = jsteps.build_train_algo(cfg, None, lay, lr=0.02,
                                             spec=spec)
    api = jget_model(cfg)
    init = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), m))
    state, fl = algo.init_flat(init, fl)
    if sampled:
        step = jax.jit(lambda s, P, a, b: algo.round_fn_sampled(s, P, a, b,
                                                                fl))
    else:
        step = jax.jit(lambda s, P, b: algo.round_fn_flat(s, P, b, fl))
    return cfg, state, step


def state_arrays(state) -> dict:
    out = {"flat": np.asarray(state.flat), "mu": np.asarray(state.mu),
           "mom_u": np.asarray(state.opt_u.momentum)}
    out.update(flat_paths(state.personal, "personal"))
    out.update(flat_paths(state.opt_v.momentum, "mom_v"))
    return out


def sampler_actives(m, rounds=ROUNDS):
    """The reference sampler's actives at frac 0.5."""
    s = jmake_spec("dfedpgp", topology="random", n_neighbors=N_NB, seed=0,
                   gossip="matrix", resident=True, participation="uniform",
                   participation_frac=0.5).sampler(m)
    return tuple(tuple(int(g) for g in s.active_at(t))
                 for t in range(rounds))


@functools.lru_cache(maxsize=None)
def round_inputs(m, actives=None, replace=()):
    """(initial arrays with each round's batches, tables and actives,
    [(table, actives, batches)]): the reference's random tables of
    N_NB neighbors (seed 7), induced on `actives` when given (compact
    batches then)."""
    cfg, state, _ = _reference_algo(m, actives is not None, replace)
    sched = jtopology.TopologySchedule.random(m, N_NB, seed=7)
    arrays = state_arrays(state)
    rng = np.random.default_rng(13)
    steps = []
    for t in range(ROUNDS):
        P = sched.at(t)
        n = m
        if actives is not None:
            act = np.asarray(actives[t], np.int32)
            P = jtopology.induced_subgraph(P, jnp.asarray(act), "row")
            arrays[f"active/{t}"] = act
            n = len(act)
        b = {}
        for part in "vu":
            tok = rng.integers(0, cfg.vocab, (n, 1, B, S)).astype(np.int32)
            b[part] = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
            for name, a in b[part].items():
                arrays[f"b/{t}/{part}/{name}"] = a
        arrays[f"idx/{t}"] = np.asarray(P.idx, np.int32)
        arrays[f"w/{t}"] = np.asarray(P.w, np.float32)
        steps.append((P, None if actives is None else actives[t], b))
    return arrays, steps


@functools.lru_cache(maxsize=None)
def reference_rounds(m, actives=None, replace=()):
    """(final state arrays, [host metrics of each round]) of the
    reference's one-device rounds over `round_inputs`."""
    _, state, step = _reference_algo(m, actives is not None, replace)
    records = []
    for P, act, b in round_inputs(m, actives, replace)[1]:
        b = jax.tree.map(jnp.asarray, b)
        if act is None:
            state, met = step(state, P, b)
        else:
            state, met = step(state, P, jnp.asarray(act, jnp.int32), b)
        records.append({k: np.asarray(v) for k, v in
                        jax.device_get(met).items() if np.ndim(v) == 0})
    return state_arrays(state), records


def rounds_job(m, T=1, actives=None, replace=(), telemetry=True,
               graph=False):
    meta = {"m": m, "tp": T, "rounds": ROUNDS, "arch": "qwen2-0.5b",
            "cfg": dict(replace), "gossip": "matrix", "n_neighbors": N_NB,
            "topology": "random", "telemetry": telemetry, "trace": True}
    if graph:
        meta["graph_seed"] = GRAPH_SEED
    return ("rounds" if actives is None else "sampled_rounds", meta,
            round_inputs(m, actives, replace)[0])


def jobs(tmp_factory, world: int, todo: dict, meanwhile=()):
    """{name: (job, meta, arrays)} in one gloo group of `world` ranks ->
    {name: output arrays}; the callables `meanwhile` (the reference's side)
    run while the ranks do."""
    tmp = tmp_factory.mktemp(f"sampled{world}")
    argv = ["-m", "repro_torch.launch.ranks_check", "--world", str(world),
            "--device", "cpu"]
    for name, (job, meta, arrays) in todo.items():
        np.savez(tmp / f"{name}.in.npz", meta=json.dumps(meta), **arrays)
        argv += ["--job", job, str(tmp / f"{name}.in.npz"),
                 str(tmp / f"{name}.out.npz")]
    proc = _start(argv, tmp)
    try:
        for fn in meanwhile:
            fn()
    finally:
        _finish(proc)
    return {name: dict(np.load(tmp / f"{name}.out.npz")) for name in todo}


def _start(argv, tmp: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TMPDIR=str(tmp))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable] + argv, env=env, cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen, timeout: int = TIMEOUT) -> None:
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]


def check_state(got, m, actives=None, replace=(), mu_rtol=0.0):
    """The final state against the reference's (mu bit for bit where its
    mix gathers, at `mu_rtol` where it densifies); each round's dormant
    rows bit for bit the round before's."""
    arrays = round_inputs(m, actives, replace)[0]
    want, _ = reference_rounds(m, actives, replace)
    for k, x in want.items():
        np.testing.assert_allclose(got[k], x, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=mu_rtol, atol=0)
    prev = {k: arrays[k] for k in ("flat", "mom_u", "mu")}
    for t in range(ROUNDS):
        now = {k: got[f"{k}/{t}"] for k in prev}
        if actives is not None:
            dormant = np.setdiff1d(np.arange(m), actives[t])
            for k in prev:
                np.testing.assert_array_equal(now[k][dormant],
                                              prev[k][dormant], err_msg=k)
        prev = now
    np.testing.assert_array_equal(prev["flat"], got["flat"])
    assert np.abs(got["flat"] - arrays["flat"]).max() > 1e-4


def check_gauges(got, m, actives=None, replace=()):
    """Every round's metrics (the gauges among them) against the
    reference's records."""
    _, records = reference_rounds(m, actives, replace)
    for t, want in enumerate(records):
        mine = {k[len(f"metrics/{t}/"):]: v for k, v in got.items()
                if k.startswith(f"metrics/{t}/")}
        assert set(mine) == set(want)
        assert "consensus_gap_mean" in mine and "grad_norm" in mine
        for k, x in want.items():
            np.testing.assert_allclose(mine[k], x, rtol=G_RTOL, atol=G_ATOL,
                                       err_msg=f"round {t}: {k}")


def check_telemetry_is_pure(on, off):
    """Telemetry on leaves every state leaf bit for bit as off does."""
    keys = {k for k in off if not k.startswith("metrics/")}
    assert keys == {k for k in on if not k.startswith(("metrics/",
                                                        "graph/"))}
    for k in keys:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


# ---------------------------------------------------------------------------
# W 2: sampled and resident rounds, gauges, a graph record
# ---------------------------------------------------------------------------
ACT2 = sampler_actives(M)


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    todo = {"sampled": rounds_job(M, actives=ACT2, graph=True),
            "sampled_off": rounds_job(M, actives=ACT2, telemetry=False),
            "resident": rounds_job(M),
            "resident_off": rounds_job(M, telemetry=False)}
    meanwhile = [lambda: reference_rounds(M, ACT2), lambda:
                 reference_rounds(M)]
    return jobs(tmp_path_factory, 2, todo, meanwhile)


def test_w2_actives_cross_ranks_and_gather():
    for t, act in enumerate(ACT2):
        assert len(act) == 4
        P = round_inputs(M, ACT2)[1][t][0]
        owner = np.searchsorted(np.asarray(act), [0, M // 2])
        cut = owner[1]
        idx = np.asarray(P.idx)
        # a compact row reads one owned by the other rank
        assert ((idx[:cut] >= cut).any() or (idx[cut:] < cut).any())
        assert idx.shape[1] < len(act)       # the reference gathers


def test_sampled_rounds_w2_match_reference(group2):
    check_state(group2["sampled"], M, ACT2)


def test_sampled_gauges_w2_match_reference(group2):
    check_gauges(group2["sampled"], M, ACT2)
    for t in range(ROUNDS):
        assert int(group2["sampled"][f"metrics/{t}/n_active"]) == 4


@pytest.mark.parametrize("kind", ["sampled", "resident"])
def test_telemetry_on_is_off_bitwise_w2(group2, kind):
    check_telemetry_is_pure(group2[kind], group2[kind + "_off"])


def test_resident_gauges_w2_match_reference(group2):
    check_state(group2["resident"], M)
    check_gauges(group2["resident"], M)


def test_graph_record_w2_matches_the_one_device_record(group2):
    got = group2["sampled"]
    personal = tree.from_paths(
        (tuple(k.split("/")[1:]), torch.from_numpy(v))
        for k, v in got.items() if k.startswith("personal/"))
    sched = tmake_spec("dfedpgp", topology="random", n_neighbors=N_NB,
                       seed=0).schedule(M)
    ring = tsink.RingSink()
    t0 = ROUNDS - 1
    tgraph.emit_graph_record(
        ring, run_id="ranks_check", algo="dfedpgp", m=M, seed=GRAPH_SEED,
        schedule=sched, step=t0, t0=t0, flat=torch.from_numpy(got["flat"]),
        mu=torch.from_numpy(got["mu"]), personal=personal,
        active=np.asarray(ACT2[-1]))
    want = ring.last("graph")
    fields = {k[len("graph/"):]: v for k, v in got.items()
              if k.startswith("graph/")}
    numeric = {k for k, v in want.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    assert set(fields) == numeric
    assert {"row_cos_mean", "head_dist_max", "contraction"} <= numeric
    for k in numeric:
        np.testing.assert_allclose(fields[k], want[k], rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# train.py --ranks 2 --sample 0.5 --telemetry
# ---------------------------------------------------------------------------
TRAIN = ["--arch", "qwen2-0.5b", "--reduced", "--rounds", "2", "--clients",
         "8", "--batch", "2", "--seq", "16", "--neighbors", "2",
         "--resident", "--sample", "0.5", "--telemetry", "--device", "cpu"]


def _records(path, kind="round"):
    return [r for r in trecord.load_jsonl(str(path)) if r["kind"] == kind]


def test_train_sampled_telemetry_across_ranks_gives_the_one_rank_records(
        tmp_path, capsys):
    ttrain.main(TRAIN + ["--metrics", str(tmp_path / "one")])
    capsys.readouterr()
    proc = _start(["-m", "repro_torch.launch.train"] + TRAIN
                  + ["--ranks", "2", "--metrics", str(tmp_path / "two")],
                  tmp_path)
    _finish(proc)
    one, two = _records(tmp_path / "one"), _records(tmp_path / "two")
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        assert a["n_active"] == b["n_active"] == 4
        assert a["wire_bytes"] == b["wire_bytes"]
        for key in ("loss", "loss_v", "mu_min", "mu_max", "mass_total",
                    "consensus_gap_mean", "consensus_gap_max",
                    "moved_mass", "grad_norm", "wire_edges"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# build_train_step's sampled step on a client mesh (one rank, this process)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group of this process, destroyed after the
    module."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    tmp = tempfile.mkdtemp(prefix="sampled_one_rank_")
    tranks.init(0, 1, os.path.join(tmp, "rendezvous"), "cpu")
    try:
        yield tmesh.make_host_mesh(M)
    finally:
        dist.destroy_process_group()


def test_build_train_step_sampled_on_a_client_mesh_is_the_one_device_step(
        one_rank):
    # W 1 holds every client: the rank's share is the whole compact set,
    # and its mix gathers as the one-device mix does at k 3 < n_act 4, so
    # the two steps agree bit for bit on the state
    from repro_torch.configs import InputShape
    from repro_torch.configs import get_reduced as tget_reduced
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps as tsteps
    cfg = tget_reduced("qwen2-0.5b").replace(compute_dtype="float32")
    spec = tmake_spec("dfedpgp", topology="random", n_neighbors=N_NB,
                      seed=0, gossip="matrix", resident=True,
                      participation="uniform", participation_frac=0.5)
    lay = tmesh.one_device_layout(M, B)
    shape = InputShape("train_tiny", S, M * B, "train")
    algo, _, _, fl = tsteps.build_train_algo(cfg, None, lay, spec=spec)
    steps_ = {name: tsteps.build_train_step(cfg, mesh, lay, shape,
                                            spec=spec)[0]
              for name, mesh in (("one", None), ("mesh", one_rank))}
    # two states from the one seeded init (the rounds write in place)
    states = {k: algo.init_flat(ttrain.init_stacked(cfg, M, "cpu"), fl,
                                device="cpu")[0] for k in steps_}
    sched, sampler = spec.schedule(M), spec.sampler(M)
    rng = np.random.default_rng(2)
    for t in range(2):
        act = sampler.active_at(t)
        P = ttopology.induced_subgraph(sched.at(t), act, "row")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (len(act), 1, B, S)))
        b = {p: {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
             for p in "vu"}
        states["one"], m1 = steps_["one"](states["one"], P,
                                          torch.as_tensor(act), b)
        states["mesh"], m2 = steps_["mesh"](states["mesh"], P, act, b)
        assert m2["n_active"] == m1["n_active"] == 4
        for k in ("loss_v", "loss_u", "mu_min", "mu_max"):
            np.testing.assert_allclose(float(m2[k]), float(m1[k]),
                                       rtol=1e-6, err_msg=k)
    one, mesh = states["one"], states["mesh"]
    for name in ("flat", "mu"):
        assert torch.equal(getattr(one, name), getattr(mesh, name)), name
    assert torch.equal(one.opt_u.momentum, mesh.opt_u.momentum)
    for a, b in ((one.personal, mesh.personal),
                 (one.opt_v.momentum, mesh.opt_v.momentum)):
        for (p, x), (_, y) in zip(tree.paths(a), tree.paths(b)):
            assert torch.equal(x, y), p
