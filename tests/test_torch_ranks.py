"""Regime B across ranks (`repro_torch.launch.ranks`, the cross-rank mixes
of `launch/steps.py`, `train.py --ranks`) against the JAX reference.

Each gloo group runs in a subprocess of a module of the package
(`python -m repro_torch.launch.ranks_check`, or the trainer's `--ranks`),
which spawns its ranks, so the children never import this file; each has
its own timeout and a `file://` rendezvous in a fresh temporary
directory.  The same numpy inputs go through the reference:
- the flat and tree permutation mixes at W 2 and 4, m 8, 4 rounds of the
  exponential schedule: bitwise the reference's roll formula
  0.5 * (u + roll(u, off)), and within 1e-6 of its `gossip.mix_flat`
  over `schedule.at(t)` (tests/test_regime_parity.py's tolerance); a bf16
  wire bitwise the same formula with the sent copy narrowed;
- the matrix mix across ranks over a random table whose neighbors cross
  ranks, against the reference's `mix_flat` on one device;
- 3 resident rounds of reduced() qwen2-0.5b at W 2, m 4 with each mix
  against the reference's one-device `round_fn_flat` over the same
  schedule (its 8-device tests fail on jax 0.9.0, so what it computes on
  one device is the oracle): every state leaf at the Regime B tolerance
  (rtol 1e-4, atol 2e-5), mu exact;
- `train.main(["--ranks", "2", ...])`'s records against the one-rank
  run's, and the refusals.
The plans themselves (`permutation_steps`, `gather_plan`) are checked
as pure functions: every pair of ranks agrees on what crosses."""
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
from repro.core import gossip as jgossip
from repro.core import topology as jtopology
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.spec import make_algo_spec as jmake_spec
from repro_torch.core import topology as ttopology
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks as tranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.obs import record as trecord

SRC = str(Path(__file__).resolve().parent.parent / "src")
M, D, ROUNDS = 8, 37, 4
RTOL, ATOL = 1e-4, 2e-5
TIMEOUT = 240


def _run(argv, tmp: Path, timeout: int = TIMEOUT) -> None:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TMPDIR=str(tmp))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    res = subprocess.run([sys.executable] + argv, env=env, cwd=str(tmp),
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]


def _jobs(tmp_factory, world: int, jobs: dict) -> dict:
    """{name: (job, meta, arrays)} run in one gloo group of `world` ranks
    -> {name: output arrays}."""
    tmp = tmp_factory.mktemp(f"ranks{world}")
    argv = ["-m", "repro_torch.launch.ranks_check", "--world", str(world),
            "--device", "cpu"]
    for name, (job, meta, arrays) in jobs.items():
        np.savez(tmp / f"{name}.in.npz", meta=json.dumps(meta), **arrays)
        argv += ["--job", job, str(tmp / f"{name}.in.npz"),
                 str(tmp / f"{name}.out.npz")]
    _run(argv, tmp)
    return {name: dict(np.load(tmp / f"{name}.out.npz")) for name in jobs}


def _inputs(seed=0, m=M, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            (0.5 + rng.random(m)).astype(np.float32))


# ---------------------------------------------------------------------------
# the plans (pure functions)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,world", [(8, 2), (8, 4), (8, 8), (12, 3),
                                     (6, 1)])
@pytest.mark.parametrize("off", [0, 1, 2, 5])
def test_permutation_steps_pair_up_across_ranks(m, world, off):
    n = m // world
    plans = [tranks.permutation_steps(m, world, r, off) for r in
             range(world)]
    for r, plan in enumerate(plans):
        assert [st.row for st in plan] == list(range(n))
        for st in plan:
            j = r * n + st.row
            assert st.src == (j - off) % m
            assert (st.local is None) == (st.src // n != r)
            if st.local is not None:
                assert st.local == st.src - r * n
            else:
                # the peer sends exactly this row in the same step
                sends = plans[st.peer][st.row].sends
                assert (st.src - st.peer * n, r) in sends
        for s, st in enumerate(plan):
            for local, q in st.sends:
                assert plans[q][s].peer == r
                assert plans[q][s].src == r * n + local


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_plan_sends_what_each_rank_reads(world, seed):
    sched = ttopology.get_schedule("random", M, 3, seed)
    idx = sched.at(0).idx.tolist()
    plans = [tranks.gather_plan(idx, M, world, r) for r in range(world)]
    n = M // world
    for r, plan in enumerate(plans):
        reads = {g for row in idx[r * n:(r + 1) * n] for g in row}
        assert set(plan.halo) == reads - set(range(r * n, (r + 1) * n))
        assert sorted(g for _, rows in plan.recv for g in rows) == \
            list(plan.halo)
        for q, rows in plan.recv:
            assert dict(plans[q].send)[r] == rows
        positions = sorted(plan.position(g) for g in
                           set(range(r * n, (r + 1) * n)) | reads)
        assert positions == list(range(n + len(plan.halo)))


def test_row_range_refuses_unequal_blocks():
    assert tranks.row_range(8, 4, 3) == (6, 8)
    with pytest.raises(ValueError, match="m % W == 0"):
        tranks.row_range(6, 4, 0)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl"),
                                            ("cuda:1", "nccl")])
def test_backend_follows_the_device(device, backend):
    assert tranks.backend_for(device) == backend


def test_backend_refuses_meta():
    with pytest.raises(ValueError, match="no process-group backend"):
        tranks.backend_for("meta")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_descriptions(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    want = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    assert mesh.axis_names == tuple(want) and mesh.shape == want


def test_host_mesh_refuses_tp_and_needs_a_group(tmp_path):
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="ranks.init"):
        tmesh.make_host_mesh(4)
    # a one-rank group cannot hold two model ranks: W % T != 0
    tranks.init(0, 1, str(tmp_path / "rendezvous"), "cpu")
    try:
        with pytest.raises(ValueError, match=r"W % T == 0"):
            tmesh.make_host_mesh(4, model=2)
        mesh = tmesh.make_host_mesh(4, model=1)
        assert (mesh.world, mesh.shape["model"], mesh.rows) == (1, 1, (0, 4))
    finally:
        dist.destroy_process_group()


def test_one_device_layout_and_mesh_spec():
    lay = tmesh.one_device_layout(4, 2)
    assert lay == tsteps.Layout(("data",), (), ("model",), (), 4, 2)
    with pytest.raises(ValueError, match="one size per distinct"):
        tmesh.mesh_spec((2, 2), ("data", "data"))


def test_ppermute_train_algo_needs_a_client_mesh():
    from repro_torch import configs
    cfg = configs.get_reduced("qwen2-0.5b")
    lay = tmesh.one_device_layout(4, 2)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="client mesh"):
            tsteps.build_train_algo(cfg, None, lay, gossip="ppermute")


# ---------------------------------------------------------------------------
# the flat and tree permutation mixes
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_mixes(wire=None):
    """The reference's roll formula and its mix_flat over the schedule,
    chained over ROUNDS rounds."""
    u0, mu0 = _inputs()
    sched = jtopology.TopologySchedule.exponential(M)
    offs = sched.permutation_offsets()
    roll, roll_mu, mixed, mixed_mu = [], [], [], []
    u, mu, v, nu = jnp.asarray(u0), jnp.asarray(mu0), jnp.asarray(u0), \
        jnp.asarray(mu0)
    for t in range(ROUNDS):
        off = offs[t % len(offs)]
        sent = u.astype(wire).astype(u.dtype) if wire else u
        u = 0.5 * (u + jnp.roll(sent, off, 0))
        mu = 0.5 * (mu + jnp.roll(mu, off, 0))
        roll.append(np.asarray(u))
        roll_mu.append(np.asarray(mu))
        v, nu = jgossip.mix_flat(sched.at(t), v, nu, mode="sparse")
        mixed.append(np.asarray(v))
        mixed_mu.append(np.asarray(nu))
    return roll, roll_mu, mixed, mixed_mu


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """One gloo group each at W 2 and 4: the flat, tree and matrix mixes,
    and at W 2 the resident rounds with both mixes."""
    u, mu = _inputs()
    um, mum = _inputs(seed=5)
    out = {}
    for w in (2, 4):
        matrix = {"flat": um, "mu": mum}
        for t, P in enumerate(_crossing_tables(M, 3, ROUNDS, w)):
            matrix[f"idx/{t}"] = np.asarray(P.idx, np.int32)
            matrix[f"w/{t}"] = np.asarray(P.w, np.float32)
        jobs = {"flat": ("mix_flat", {"m": M, "rounds": ROUNDS},
                         {"flat": u, "mu": mu}),
                "tree": ("mix_tree", {"m": M, "rounds": ROUNDS,
                                      "wire_dtype": "bfloat16",
                                      "shared": ["body/w", "body/b"]},
                         dict(_tree_inputs(), mu=mu)),
                "matrix": ("matrix", {"m": M, "rounds": ROUNDS}, matrix)}
        if w == 2:
            for g in ("ppermute", "matrix"):
                jobs["rounds_" + g] = (
                    "rounds", {"m": RM, "rounds": RROUNDS, "arch": ARCH,
                               "gossip": g, "n_neighbors": 1,
                               "topology": "exponential"
                               if g == "ppermute" else "random"},
                    _reference_rounds(g)[0])
        out[w] = _jobs(tmp_path_factory, w, jobs)
    return out


@pytest.fixture(scope="module")
def mixes(groups):
    return groups


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("t", range(ROUNDS))
def test_flat_ppermute_mix_is_the_roll_formula_bitwise(mixes, world, t):
    roll, roll_mu, _, _ = _reference_mixes()
    got = mixes[world]["flat"]
    np.testing.assert_array_equal(got[f"flat/{t}"], roll[t])
    np.testing.assert_array_equal(got[f"mu/{t}"], roll_mu[t])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("t", range(ROUNDS))
def test_flat_ppermute_mix_matches_schedule_mix(mixes, world, t):
    _, _, mixed, mixed_mu = _reference_mixes()
    got = mixes[world]["flat"]
    np.testing.assert_allclose(got[f"flat/{t}"], mixed[t], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got[f"mu/{t}"], mixed_mu[t], rtol=1e-6,
                               atol=1e-6)


def _tree_inputs():
    rng = np.random.default_rng(3)
    return {"params/body/w": rng.standard_normal((M, 3, 5)).astype(
                np.float32),
            "params/body/b": rng.standard_normal((M, 7)).astype(np.float32),
            "params/head": rng.standard_normal((M, 4)).astype(np.float32)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("leaf", ["body/w", "body/b", "head"])
def test_tree_ppermute_mix_bf16_wire_is_the_reference_formula(mixes, world,
                                                              leaf):
    sched = jtopology.TopologySchedule.exponential(M)
    offs = sched.permutation_offsets()
    a = jnp.asarray(_tree_inputs()["params/" + leaf])
    for t in range(ROUNDS):
        if leaf != "head":        # the personal leaf never moves
            recv = jnp.roll(a.astype(jnp.bfloat16), offs[t % len(offs)], 0)
            a = (a + recv.astype(a.dtype)) * 0.5
        np.testing.assert_array_equal(
            mixes[world]["tree"][f"params/{t}/{leaf}"], np.asarray(a))


@pytest.mark.parametrize("world", [2, 4])
def test_tree_ppermute_mix_moves_mu_in_f32(mixes, world):
    _, roll_mu, _, _ = _reference_mixes()
    for t in range(ROUNDS):
        np.testing.assert_array_equal(mixes[world]["tree"][f"mu/{t}"],
                                      roll_mu[t])


# ---------------------------------------------------------------------------
# the matrix mix across ranks
# ---------------------------------------------------------------------------
def _crossing_tables(m, n, rounds, world):
    """The reference's random directed tables; at least one neighbor of
    each round lies on another rank."""
    sched = jtopology.TopologySchedule.random(m, n, seed=7)
    tables = [sched.at(t) for t in range(rounds)]
    blk = m // world
    for P in tables:
        idx = np.asarray(P.idx)
        assert (idx // blk != (np.arange(m) // blk)[:, None]).any()
    return tables


@pytest.mark.parametrize("world", [2, 4])
def test_matrix_mix_across_ranks_matches_reference(mixes, world):
    u, mu = _inputs(seed=5)
    got = mixes[world]["matrix"]
    v, nu = jnp.asarray(u), jnp.asarray(mu)
    for t, P in enumerate(_crossing_tables(M, 3, ROUNDS, world)):
        v, nu = jgossip.mix_flat(P, v, nu, mode="sparse")
        np.testing.assert_allclose(got[f"flat/{t}"], np.asarray(v),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[f"mu/{t}"], np.asarray(nu),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# resident rounds across ranks
# ---------------------------------------------------------------------------
RM, RB, RS, RROUNDS = 4, 2, 16, 3
ARCH = "qwen2-0.5b"


def _flat_paths(tree_, prefix):
    return {prefix + "/" + "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                   k)))
                                    for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree_)[0]}


@functools.lru_cache(maxsize=None)
def _reference_algo():
    """The reference's resident algo, its jitted round and the initial
    state: one compile serves both mixes' rounds (tables of k 2)."""
    cfg = jget_reduced(ARCH).replace(compute_dtype="float32")
    spec = jmake_spec("dfedpgp", topology="random", n_neighbors=1, seed=0,
                      gossip="matrix", resident=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), RM, RB)
    algo, _, _, fl = jsteps.build_train_algo(cfg, None, lay, lr=0.02,
                                             spec=spec)
    api = jget_model(cfg)
    init = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), RM))
    state, fl = algo.init_flat(init, fl)
    step = jax.jit(lambda s, P, b: algo.round_fn_flat(s, P, b, fl))
    return cfg, state, step


def _state_arrays(state) -> dict:
    out = {"flat": np.asarray(state.flat), "mu": np.asarray(state.mu),
           "mom_u": np.asarray(state.opt_u.momentum)}
    out.update(_flat_paths(state.personal, "personal"))
    out.update(_flat_paths(state.opt_v.momentum, "mom_v"))
    return out


@functools.lru_cache(maxsize=None)
def _reference_rounds(gossip_kind):
    """(initial arrays with the batches and tables, final reference
    state's arrays) of RROUNDS resident rounds on one device: the
    exponential schedule's tables for the permutation mix, random tables
    (one neighbor, crossing ranks) for the matrix mix."""
    cfg, state, step = _reference_algo()
    if gossip_kind == "ppermute":
        sched = jtopology.TopologySchedule.exponential(RM)
        tables = [sched.at(t) for t in range(RROUNDS)]
    else:
        tables = _crossing_tables(RM, 1, RROUNDS, 2)
    arrays = _state_arrays(state)
    rng = np.random.default_rng(11)
    for t, P in enumerate(tables):
        b = {}
        for part in "vu":
            tok = rng.integers(0, cfg.vocab, (RM, 1, RB, RS)).astype(np.int32)
            b[part] = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
            for name, a in b[part].items():
                arrays[f"b/{t}/{part}/{name}"] = a
        arrays[f"idx/{t}"] = np.asarray(P.idx, np.int32)
        arrays[f"w/{t}"] = np.asarray(P.w, np.float32)
        state, _ = step(state, P, jax.tree.map(jnp.asarray, b))
    return arrays, _state_arrays(state)


@pytest.fixture(scope="module")
def rounds_across_ranks(groups):
    return {g: (groups[2]["rounds_" + g], _reference_rounds(g)[1])
            for g in ("ppermute", "matrix")}


@pytest.mark.parametrize("gossip_kind", ["ppermute", "matrix"])
def test_resident_rounds_across_ranks_match_reference(rounds_across_ranks,
                                                      gossip_kind):
    got, want = rounds_across_ranks[gossip_kind]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["mu"], want["mu"])


@pytest.mark.parametrize("gossip_kind", ["ppermute", "matrix"])
def test_rounds_across_ranks_moved_the_buffer(rounds_across_ranks,
                                              gossip_kind):
    # the rounds trained and mixed: the buffer left its init
    got, _ = rounds_across_ranks[gossip_kind]
    arrays, _ = _reference_rounds(gossip_kind)
    assert np.abs(got["flat"] - arrays["flat"]).max() > 1e-4


# ---------------------------------------------------------------------------
# train.py --ranks
# ---------------------------------------------------------------------------
TRAIN = ["--arch", "qwen2-0.5b", "--reduced", "--rounds", "2", "--clients",
         "4", "--batch", "2", "--seq", "16", "--neighbors", "2",
         "--resident", "--device", "cpu"]


def _records(path):
    return [r for r in trecord.load_jsonl(str(path)) if r["kind"] == "round"]


def test_train_main_across_ranks_gives_the_one_rank_records(tmp_path,
                                                            capsys):
    ttrain.main(TRAIN + ["--metrics", str(tmp_path / "one")])
    capsys.readouterr()
    _run(["-m", "repro_torch.launch.train"] + TRAIN
         + ["--ranks", "2", "--metrics", str(tmp_path / "two")], tmp_path)
    one, two = _records(tmp_path / "one"), _records(tmp_path / "two")
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        for key in ("loss", "loss_v", "mu_min", "mu_max"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)
        assert a["wire_bytes"] == b["wire_bytes"]


def test_train_main_joins_a_torchrun_group(tmp_path):
    # RANK / WORLD_SIZE set: the trainer joins that group (env://, a
    # localhost store) as a client mesh instead of spawning
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), RANK="0",
               WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                         + TRAIN + ["--rounds", "1"], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[train] ranks=1 clients/rank=4 backend=gloo" in res.stdout


@pytest.mark.parametrize("argv,match", [
    (["--clients", "4", "--ranks", "3"], r"m % W == 0"),
    (["--arch", "xlstm-125m", "--clients", "4", "--ranks", "8", "--tp",
      "8"], "does not divide n_heads=4"),
    (["--clients", "4", "--ranks", "2", "--resident", "--sample", "0.5",
      "--gossip", "ppermute"], "use --gossip matrix"),
    (["--clients", "4", "--ranks", "2", "--resident", "--graph-every",
      "1"], "add --telemetry"),
    (["--clients", "4", "--ranks", "2", "--sample", "0.5"],
     r"--sample < 1 gathers/scatters the resident flat buffer; add "
     r"--resident"),
    (["--clients", "4", "--ranks", "2"], "add --resident")])
def test_train_ranks_refusals(argv, match, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(["--reduced", "--device", "cpu"] + argv)
    import re
    assert re.search(match, capsys.readouterr().err)
