"""Tensor parallelism across ranks (`repro_torch.launch.tp`, the
(data, model) client mesh, `train.py --ranks W --tp T`) against the JAX
reference.

The gloo groups run in subprocesses of `python -m
repro_torch.launch.ranks_check` (one group of two ranks here, one of four
in tests/test_torch_tp_rounds.py), so the children never import this
file.  The same numpy inputs and the reference's init (carried over as
arrays) go through the reference:
- the shard plan of every leaf of qwen2-0.5b, granite-3-2b and
  qwen2-vl-7b at full width (meta tensors) at T 2, 4 and 16: the split
  dim is the one the reference's `sharding.spec_for_path` puts 'model' on
  (granite's vocab 49,155 relocates embed's and lm_head's to d_model); at
  reduced widths the shards put back together give each leaf bit for bit;
- the loss and every leaf's gradient on the shards of (data 1, model 2)
  under `vmap(grad_and_value(...))` over two clients, the shards put back
  together, against `jax.value_and_grad` of the reference's `loss_fn`
  (tests/test_torch_dense.py's f32 tolerance): reduced() qwen2-0.5b,
  qwen2-vl-7b, and qwen2-0.5b with vocab 257 (embed / lm_head split over
  d_model);
- 3 resident rounds of reduced() qwen2-0.5b, m 4, at (data 1, model 2)
  with both mixes, and 2 rounds of a config whose d_flat is odd (the flat
  dim replicated, embed and lm_head too), against the reference's
  one-device `round_fn_flat` over the same schedule: every state leaf at
  the Regime B tolerance (rtol 1e-4, atol 2e-5), mu exact;
- at T = 1 in this process (a one-rank gloo group): the executor's loss
  and gradients, and 2 resident matrix-mix and 2 tree-form permutation
  rounds through a one-rank client mesh, bit for bit the plain path's,
  as the card's phase `tp` holds them;
- the refusals: a split the forward does not run, named by leaf and dim
  (tests/test_torch_tp_families.py holds the other families)."""
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import topology as jtopology
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.spec import make_algo_spec as jmake_spec
from repro_torch import configs, tree
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks as tranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import tp as ttp
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget_model

SRC = str(Path(__file__).resolve().parent.parent / "src")
RTOL, ATOL = 1e-4, 2e-5                  # the Regime B rounds
LOSS_TOL, GRAD_TOL = 1e-5, 5e-5          # tests/test_torch_dense.py, f32
TIMEOUT = 240
M, B, S, ROUNDS = 4, 2, 16, 3
ODD = dict(d_model=127, head_dim=32, vocab=257)   # d_flat odd


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


def _run(argv, tmp: Path, timeout: int = TIMEOUT) -> None:
    _finish(_start(argv, tmp), timeout)


def start_jobs(tmp_factory, world: int, todo: dict):
    """{name: (job, meta, arrays)} started in one gloo group of `world`
    ranks -> the handle `finish_jobs` takes."""
    tmp = tmp_factory.mktemp(f"tp{world}")
    argv = ["-m", "repro_torch.launch.ranks_check", "--world", str(world),
            "--device", "cpu"]
    for name, (job, meta, arrays) in todo.items():
        np.savez(tmp / f"{name}.in.npz", meta=json.dumps(meta), **arrays)
        argv += ["--job", job, str(tmp / f"{name}.in.npz"),
                 str(tmp / f"{name}.out.npz")]
    return _start(argv, tmp), tmp, tuple(todo)


def finish_jobs(handle, timeout: int = TIMEOUT) -> dict:
    """The group's end -> {name: output arrays}."""
    proc, tmp, names = handle
    _finish(proc, timeout)
    return {name: dict(np.load(tmp / f"{name}.out.npz")) for name in names}


def jobs(tmp_factory, world: int, todo: dict, meanwhile=(),
         timeout: int = TIMEOUT):
    """{name: (job, meta, arrays)} in one gloo group of `world` ranks ->
    {name: output arrays}; the callables `meanwhile` (the reference's side)
    run while the ranks do."""
    handle = start_jobs(tmp_factory, world, todo)
    try:
        for fn in meanwhile:
            fn()
    finally:
        out = finish_jobs(handle, timeout)
    return out


def flat_paths(tree_, prefix):
    return {prefix + "/" + "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                   k)))
                                    for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree_)[0]}


def _jcfg(arch, **replace):
    return jget_reduced(arch).replace(compute_dtype="float32", **replace)


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------
PLAN_ARCHS = ("qwen2-0.5b", "granite-3-2b", "qwen2-vl-7b")


@functools.lru_cache(maxsize=None)
def _template(arch: str):
    return tree.tree_map(lambda a: a[0], tsteps.stacked_param_struct(
        configs.get_config(arch), 1))


@pytest.mark.parametrize("T", [2, 4, 16])
@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_shard_plan_is_the_reference_placement(arch, T):
    template = _template(arch)
    plan = ttp.shard_plan(template, T)
    assert set(plan) == {p for p, _ in tree.paths(template)}
    for path, leaf in tree.paths(template):
        spec = tuple(jsharding.spec_for_path("/".join(path),
                                             tuple(leaf.shape), ("model",),
                                             T))
        want = spec.index("model") if "model" in spec else None
        assert plan[path] == want, (path, spec)
        if want is not None:
            assert leaf.shape[want] % T == 0
    split = {p: d for p, d in plan.items() if d is not None}
    # every block matrix splits; the norms replicate
    assert split[("layers", "attn", "wq")] == 2
    assert split[("layers", "attn", "wo")] == 1
    assert split[("layers", "mlp", "wd")] == 1
    assert plan[("layers", "ln1")] is None and plan[("final_norm",)] is None
    vocab = jget_config(arch).vocab
    want_embed = (0, 1) if vocab % T == 0 else (1, 0)
    assert (plan[("embed",)], plan[("lm_head",)]) == want_embed


def test_granite_relocates_embed_and_head_to_d_model():
    plan = ttp.shard_plan(_template("granite-3-2b"), 2)
    assert 49_155 % 2 and plan[("embed",)] == 1 and plan[("lm_head",)] == 0


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "codeqwen1.5-7b",
                                  "qwen2-vl-7b"])
def test_shards_put_back_together_bitwise(arch, T):
    cfg = configs.get_reduced(arch).replace(vocab=258)
    full = tget_model(cfg).init_params(torch.Generator().manual_seed(1),
                                       cfg, device="cpu")
    plan = ttp.shard_plan(full, T)
    parts = [ttp.shard_tree(full, plan, T, t, copy=True) for t in range(T)]
    for path, leaf in tree.paths(full):
        dim = plan[path]
        pieces = [tree.get(p, path) for p in parts]
        if dim is None:
            assert all(x is leaf for x in pieces)
            continue
        assert all(x.shape[dim] == leaf.shape[dim] // T for x in pieces)
        assert torch.equal(torch.cat(pieces, dim=dim), leaf), path


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,replace,T,match", [
    ("recurrentgemma-9b", {"lru_width": 130}, 4,
     r"leaf period_lru/rec/b_a \(1, 2, 130\): the plan replicates it"),
    ("deepseek-moe-16b", {"n_experts": 6}, 4,
     r"does not divide n_experts=6.*leaf moe_layers/moe/wg"),
    ("xlstm-125m", {}, 8, r"does not divide n_heads=4.*leaf layers/0/wq"),
    ("whisper-large-v3", {"d_ff": 250}, 4,
     r"leaf dec_layers/mlp/b1 \(2, 250\): the plan replicates it")])
def test_check_tp_refuses_other_families(arch, replace, T, match):
    # every family runs across ranks (its reduced() model at T 2); what
    # each refuses is a split its forward does not run, named by leaf
    cfg = configs.get_reduced(arch)
    ttp.check_tp(cfg, 1)
    ttp.check_tp(cfg, 2)
    with pytest.raises(ValueError, match=match):
        ttp.check_tp(cfg.replace(**replace), T)


@pytest.mark.parametrize("field,T", [("n_kv_heads", 4), ("n_heads", 3),
                                     ("d_ff", 3)])
def test_check_tp_refuses_a_split_of_heads_or_columns(field, T):
    # n_kv_heads: 3 KV heads of 33 columns at T 4 cut inside a head, which
    # the gathered K / V run, but 99 columns relocate wk's split to
    # d_model; n_heads: whole query heads; d_ff: 256 at T 3 (6 / 3 heads
    # split) replicates the MLP, which the forward splits
    cfg = configs.get_reduced("qwen2-0.5b").replace(
        n_heads={"n_kv_heads": 12, "n_heads": 4, "d_ff": 6}[field],
        n_kv_heads={"n_kv_heads": 3, "n_heads": 2, "d_ff": 3}[field],
        head_dim=33 if field == "n_kv_heads" else 0)
    match = {"n_kv_heads": r"leaf layers/attn/bk \(2, 99\): the plan "
                           r"replicates it",
             "n_heads": "does not divide n_heads=4",
             "d_ff": r"leaf layers/mlp/wd \(2, 256, 128\): the plan "
                     r"replicates it"}[field]
    with pytest.raises(ValueError, match=match):
        ttp.check_tp(cfg, T)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "xlstm-125m", "--ranks", "8", "--tp", "8", "--clients",
      "1"], "does not divide n_heads=4"),
    (["--ranks", "3", "--tp", "3", "--clients", "3"],
     "does not divide n_heads=4"),
    (["--ranks", "3", "--tp", "2"], r"W % T == 0"),
    (["--ranks", "4", "--tp", "2", "--clients", "3"], r"m % W == 0"),
    (["--ranks", "2", "--tp", "2", "--sample", "0.5", "--gossip",
      "ppermute"], "use --gossip matrix")])
def test_train_refuses_tp(argv, match, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(["--reduced", "--device", "cpu", "--resident",
                     "--clients", "4"] + argv)
    assert re.search(match, capsys.readouterr().err)


# ---------------------------------------------------------------------------
# T = 1 in this process: the executor is the plain path bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group of this process, destroyed after the
    module."""
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="tp_one_rank_")
    tranks.init(0, 1, os.path.join(tmp, "rendezvous"), "cpu")
    try:
        yield tmesh.make_host_mesh(M, model=1)
    finally:
        dist.destroy_process_group()


def _lm_batch(cfg, lead, seed=3):
    rng = np.random.default_rng(seed)
    S_text = S - cfg.n_vision_tokens if cfg.family == "vlm" else S
    tok = rng.integers(0, cfg.vocab, tuple(lead) + (S_text,))
    b = {"tokens": torch.as_tensor(tok), "labels":
         torch.as_tensor(np.roll(tok, -1, -1))}
    if cfg.family == "vlm":
        b["vision"] = torch.as_tensor(rng.standard_normal(
            tuple(lead) + (cfg.n_vision_tokens, cfg.d_model)).astype(
                np.float32))
    return b


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-7b"])
def test_one_rank_loss_and_gradients_are_the_plain_ones_bitwise(one_rank,
                                                                arch):
    cfg = configs.get_reduced(arch).replace(n_vision_tokens=8)
    api = tget_model(cfg)
    params = tree.tree_map(lambda a: torch.stack([a, a * 0.5]),
                           api.init_params(torch.Generator().manual_seed(2),
                                           cfg, device="cpu"))
    batch = _lm_batch(cfg, (2, B))
    shards = ttp.Executor(cfg, one_rank, tree.tree_map(lambda a: a[0],
                                                       params))
    assert shards.model is not None
    fn = torch.func.vmap(torch.func.grad_and_value(shards.loss_fn(api,
                                                                  cfg)))
    plain = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: api.loss_fn(p, b, cfg)))
    (g, loss), (g0, loss0) = fn(shards.shard(params), batch), \
        plain(params, batch)
    assert torch.equal(loss, loss0)
    for path, x in tree.paths(g0):
        assert torch.equal(tree.get(g, path), x), path


@pytest.mark.parametrize("gossip", ["matrix", "ppermute"])
def test_one_rank_rounds_are_the_one_device_rounds_bitwise(one_rank,
                                                           gossip):
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--clients", str(M),
            "--batch", str(B), "--seq", str(S), "--device", "cpu",
            "--gossip", gossip, "--topology", "exponential"] + (
                ["--resident"] if gossip == "matrix" else [])
    ap = ttrain.build_parser()
    # on one device ppermute falls back to the matrix mix over the same
    # schedule
    one = ttrain.Trainer(ap.parse_args(argv), ap)
    mesh = ttrain.Trainer(ap.parse_args(argv), ap, one_rank)
    assert mesh.algo.tp is not None and one.algo.tp is None
    for r in range(2):
        b = one.batches(r)
        one.step(r, b)
        mesh.step(r, b)
    # the permutation mix (a + recv) * 0.5 and the one-device matrix mix
    # 0.5 a + 0.5 recv round alike: halving is exact
    want, got = _leaves(one.state), _leaves(mesh.state)
    assert want.keys() == got.keys()
    for k, x in want.items():
        assert torch.equal(got[k], x), k


def _leaves(state) -> dict:
    """{field/path: tensor} of a round state (its SGDState momenta
    unwrapped)."""
    out = {}
    for name in state._fields:
        val = getattr(state, name)
        if hasattr(val, "momentum"):
            val = val.momentum
        if val is None:
            continue
        for p, x in tree.paths({name: val}):
            out["/".join(map(str, p))] = x
    return out


# ---------------------------------------------------------------------------
# (data 1, model 2) on gloo: the loss, gradients and resident rounds
# ---------------------------------------------------------------------------
LOSS_CASES = {"qwen2": ("qwen2-0.5b", {}),
              "vlm": ("qwen2-vl-7b", {}),
              "vocab257": ("qwen2-0.5b", {"vocab": 257})}


@functools.lru_cache(maxsize=None)
def loss_inputs(arch, **replace):
    """(config, the reference's init of two clients, their batch)."""
    cfg = _jcfg(arch, **replace)
    api = jget_model(cfg)
    params = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    rng = np.random.default_rng(5)
    S_text = S - cfg.n_vision_tokens if cfg.family == "vlm" else S
    tok = rng.integers(0, cfg.vocab, (2, B, S_text)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (2, B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return cfg, params, batch


@functools.lru_cache(maxsize=None)
def loss_case(arch, **replace):
    """((m,) reference losses, reference gradients by path) of the two
    clients of `loss_inputs`."""
    cfg, params, batch = loss_inputs(arch, **replace)
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        functools.partial(jget_model(cfg).loss_fn, cfg=cfg))))
    loss, grads = vg(params, jax.tree.map(jnp.asarray, batch))
    return np.asarray(loss), flat_paths(grads, "grad")


def loss_job(arch, T, replace):
    _, params, batch = loss_inputs(arch, **replace)
    return ("tp_loss", {"m": 2, "tp": T, "arch": arch, "cfg": replace},
            dict(flat_paths(params, "params"), **batch))


def check_loss(got, arch, replace):
    loss, grads = loss_case(arch, **replace)
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert {k for k in got if k.startswith("grad/")} == set(grads)
    for k, want in grads.items():
        np.testing.assert_allclose(got[k], want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


def crossing_tables(m, rounds, world):
    """The reference's random one-neighbor tables (a neighbor crosses data
    indices each round when world > 1)."""
    sched = jtopology.TopologySchedule.random(m, 1, seed=7)
    tables = [sched.at(t) for t in range(rounds)]
    if world > 1:
        blk = m // world
        for P in tables:
            idx = np.asarray(P.idx)
            assert (idx // blk != (np.arange(m) // blk)[:, None]).any()
    return tables


@functools.lru_cache(maxsize=None)
def _reference_algo(resident: bool, replace=()):
    """The reference's one-device algo, its jitted round and the initial
    state of M clients (one compile serves the exponential and the random
    one-neighbor tables: both k 2)."""
    cfg = _jcfg("qwen2-0.5b", **dict(replace))
    spec = jmake_spec("dfedpgp", topology="random", n_neighbors=1, seed=0,
                      gossip="matrix", resident=resident)
    lay = jsteps.Layout(("data",), (), ("model",), (), M, B)
    algo, _, _, fl = jsteps.build_train_algo(cfg, None, lay, lr=0.02,
                                             spec=spec)
    api = jget_model(cfg)
    init = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), M))
    if resident:
        state, fl = algo.init_flat(init, fl)
        step = jax.jit(lambda s, P, b: algo.round_fn_flat(s, P, b, fl))
    else:
        state = algo.init(init)
        step = jax.jit(algo.round_fn)
    return cfg, state, step


def _state_arrays(state, resident: bool) -> dict:
    out = {"mu": np.asarray(state.mu)}
    if resident:
        out["flat"] = np.asarray(state.flat)
        out["mom_u"] = np.asarray(state.opt_u.momentum)
        out.update(flat_paths(state.personal, "personal"))
    else:
        out.update(flat_paths(state.params, "params"))
        out.update(flat_paths(state.opt_u.momentum, "mom_u"))
    out.update(flat_paths(state.opt_v.momentum, "mom_v"))
    return out


def round_inputs(gossip: str, resident: bool = True, rounds=ROUNDS,
                 world: int = 1, replace=()):
    """(initial arrays with the batches and tables, [(table, batches)] of
    each round) of `rounds` rounds: the exponential schedule's tables for
    the permutation mix, random one-neighbor tables for the matrix mix."""
    return _round_inputs(gossip, resident, rounds, world, replace)


@functools.lru_cache(maxsize=None)
def _round_inputs(gossip, resident, rounds, world, replace):
    cfg, state, _ = _reference_algo(resident, replace)
    if gossip == "ppermute":
        sched = jtopology.TopologySchedule.exponential(M)
        tables = [sched.at(t) for t in range(rounds)]
    else:
        tables = crossing_tables(M, rounds, world)
    arrays = _state_arrays(state, resident)
    rng = np.random.default_rng(11)
    steps = []
    for t, P in enumerate(tables):
        b = {}
        for part in "vu":
            tok = rng.integers(0, cfg.vocab, (M, 1, B, S)).astype(np.int32)
            b[part] = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
            for name, a in b[part].items():
                arrays[f"b/{t}/{part}/{name}"] = a
        arrays[f"idx/{t}"] = np.asarray(P.idx, np.int32)
        arrays[f"w/{t}"] = np.asarray(P.w, np.float32)
        steps.append((P, b))
    return arrays, steps


def reference_rounds(gossip: str, resident: bool = True, rounds=ROUNDS,
                     world: int = 1, replace=()):
    """The final state's arrays after the reference's one-device rounds
    over `round_inputs`."""
    return _reference_rounds(gossip, resident, rounds, world, replace)


@functools.lru_cache(maxsize=None)
def _reference_rounds(gossip, resident, rounds, world, replace):
    _, state, step = _reference_algo(resident, replace)
    for P, b in round_inputs(gossip, resident, rounds, world, replace)[1]:
        state, _ = step(state, P, jax.tree.map(jnp.asarray, b))
    return _state_arrays(state, resident)


def rounds_job(gossip: str, T: int, resident: bool = True, rounds=ROUNDS,
               world: int = 1, replace=()):
    meta = {"m": M, "tp": T, "rounds": rounds, "arch": "qwen2-0.5b",
            "cfg": dict(replace), "gossip": gossip, "n_neighbors": 1,
            "topology": "exponential" if gossip == "ppermute" else "random"}
    return ("rounds" if resident else "tree_rounds", meta,
            round_inputs(gossip, resident, rounds, world, replace)[0])


def check_rounds(got, gossip, resident=True, rounds=ROUNDS, world=1,
                 replace=()):
    arrays = round_inputs(gossip, resident, rounds, world, replace)[0]
    want = reference_rounds(gossip, resident, rounds, world, replace)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["mu"], want["mu"])
    # the rounds trained and mixed: the shared part left its init
    key = "flat" if resident else "params/embed"
    assert np.abs(got[key] - arrays[key]).max() > 1e-4


ODD_KEY = tuple(sorted(ODD.items()))


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    """One gloo group of two ranks, (data 1, model 2); the reference's
    losses and rounds computed while it runs."""
    todo = {name: loss_job(arch, 2, replace)
            for name, (arch, replace) in LOSS_CASES.items()}
    for g in ("ppermute", "matrix"):
        todo["rounds_" + g] = rounds_job(g, 2)
    todo["odd"] = rounds_job("matrix", 2, rounds=2, replace=ODD_KEY)
    meanwhile = [functools.partial(loss_case, arch, **replace)
                 for arch, replace in LOSS_CASES.values()]
    meanwhile += [functools.partial(reference_rounds, g)
                  for g in ("ppermute", "matrix")]
    meanwhile.append(functools.partial(reference_rounds, "matrix", rounds=2,
                                       replace=ODD_KEY))
    return jobs(tmp_path_factory, 2, todo, meanwhile)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_tp_loss_and_gradients_match_reference(group2, case):
    arch, replace = LOSS_CASES[case]
    check_loss(group2[case], arch, replace)


@pytest.mark.parametrize("gossip", ["ppermute", "matrix"])
def test_resident_rounds_data1_model2_match_reference(group2, gossip):
    check_rounds(group2["rounds_" + gossip], gossip)


def test_odd_d_flat_replicates_the_flat_dim_and_matches_reference(group2):
    cfg = configs.get_reduced("qwen2-0.5b").replace(**ODD)
    template = tree.tree_map(lambda a: a[0],
                             tsteps.stacked_param_struct(cfg, 1))
    plan = ttp.shard_plan(template, 2)
    assert plan[("embed",)] is None and plan[("lm_head",)] is None
    want = reference_rounds("matrix", rounds=2, replace=ODD_KEY)
    assert want["flat"].shape[1] % 2 == 1
    check_rounds(group2["odd"], "matrix", rounds=2, replace=ODD_KEY)
