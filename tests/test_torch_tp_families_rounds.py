"""Resident rounds of the hybrid, moe, ssm and encdec families across
ranks, and the four-rank tensor-parallel cases, against the JAX reference
(in a file of their own, so that they run beside
tests/test_torch_tp_families.py; a two-rank and a four-rank gloo group
run side by side):
- 3 resident matrix-mix rounds, m 4, of reduced() recurrentgemma-9b,
  deepseek-moe-16b, xlstm-125m and whisper-large-v3 at (data 1, model 2)
  (the two-rank group), and of xlstm-125m at (data 2, model 2), against
  the reference's one-device `round_fn_flat` over the same random
  one-neighbor tables (a neighbor crosses data indices every round) from
  the reference's init: every state leaf at the Regime B tolerance (rtol
  1e-4, atol 2e-5), mu exact;
- xlstm-125m's shared momentum (the sum of its rounds' gradients, values
  up to 4.6) is a known difference: the port's one-device f32 rounds
  part from the reference's by 8.6e-4 at most, and the reference's own
  f32 rounds part from its f64 evaluation (jax x64) by 2.3e-3, the
  port's by 1.4e-3.  So that leaf is held against the port's one-device
  rounds at the Regime B tolerance and against the reference at atol
  `KNOWN_GAP`, and `test_xlstm_momentum_gap_is_f32_rounding` holds the
  f64 reading;
- at (data 1, model 4): whisper-large-v3 (4 heads) and qwen2-0.5b (2 KV
  heads: K / V cut inside a head and all-gathered), the loss and every
  leaf's gradient against `jax.value_and_grad` of the reference's
  `loss_fn` at the dense family's f32 tolerance."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import get_model as jget_model
from repro.launch import steps as jsteps
from repro.spec import make_algo_spec as jmake_spec
from test_torch_tp import (ATOL, RTOL, SRC, TIMEOUT, _state_arrays,
                           crossing_tables, finish_jobs, start_jobs)
from test_torch_tp_families import (B, S, check_loss, jcfg, loss_case,
                                    loss_job)

M, ROUNDS = 4, 3
ROUND_ARCHS = ("recurrentgemma-9b", "deepseek-moe-16b", "xlstm-125m",
               "whisper-large-v3")
DATA2 = "xlstm-125m"
MODEL4 = ("whisper-large-v3", "qwen2-0.5b")


@functools.lru_cache(maxsize=None)
def _reference_algo(arch: str):
    """The reference's one-device resident algo of `arch`, its jitted
    round and the initial state of M clients."""
    cfg = jcfg(arch)
    spec = jmake_spec("dfedpgp", topology="random", n_neighbors=1, seed=0,
                      gossip="matrix", resident=True)
    lay = jsteps.Layout(("data",), (), ("model",), (), M, B)
    algo, _, _, fl = jsteps.build_train_algo(cfg, None, lay, lr=0.02,
                                             spec=spec)
    api = jget_model(cfg)
    init = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), M))
    state, fl = algo.init_flat(init, fl)
    step = jax.jit(lambda s, P, b: algo.round_fn_flat(s, P, b, fl))
    return cfg, state, step


@functools.lru_cache(maxsize=None)
def round_inputs(arch: str):
    """(initial arrays with the batches and tables, [(table, batches)] of
    each round): the reference's random one-neighbor tables, which cross
    the two data indices every round, serve every mesh."""
    cfg, state, _ = _reference_algo(arch)
    arrays = _state_arrays(state, True)
    rng = np.random.default_rng(11)
    steps = []
    for t, P in enumerate(crossing_tables(M, ROUNDS, 2)):
        b = {}
        for part in "vu":
            tok = rng.integers(0, cfg.vocab, (M, 1, B, S)).astype(np.int32)
            b[part] = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
            if cfg.family == "encdec":
                b[part]["frames"] = rng.standard_normal(
                    (M, 1, B, cfg.n_frames, cfg.d_model)).astype(np.float32)
            for name, a in b[part].items():
                arrays[f"b/{t}/{part}/{name}"] = a
        arrays[f"idx/{t}"] = np.asarray(P.idx, np.int32)
        arrays[f"w/{t}"] = np.asarray(P.w, np.float32)
        steps.append((P, b))
    return arrays, steps


@functools.lru_cache(maxsize=None)
def reference_rounds(arch: str):
    """The final state's arrays after the reference's rounds."""
    _, state, step = _reference_algo(arch)
    for P, b in round_inputs(arch)[1]:
        state, _ = step(state, P, jax.tree.map(jnp.asarray, b))
    return _state_arrays(state, True)


# (arch, leaf): the atol against the reference of a leaf also held against
# the port's one-device rounds (see above)
KNOWN_GAP = {("xlstm-125m", "mom_u"): 1e-3}


@functools.lru_cache(maxsize=None)
def port_rounds(arch: str):
    """The final state's arrays after the port's one-device rounds over
    `round_inputs` from the same initial state."""
    import torch
    from repro_torch import configs, convert
    from repro_torch.core import topology
    from repro_torch.launch import steps as tsteps
    from repro_torch.spec import make_algo_spec
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    spec = make_algo_spec("dfedpgp", topology="random", n_neighbors=1,
                          seed=0, gossip="matrix", resident=True)
    lay = tsteps.Layout(("data",), (), ("model",), (), M, B)
    algo, _, _, fl = tsteps.build_train_algo(cfg, None, lay, lr=0.02,
                                             spec=spec)
    _, sj, _ = _reference_algo(arch)
    state = convert.flat_state_from_reference(
        flat=np.asarray(sj.flat), personal=jax.tree.map(np.asarray,
                                                        sj.personal),
        mu=np.asarray(sj.mu), mom_u=np.asarray(sj.opt_u.momentum),
        mom_v=jax.tree.map(np.asarray, sj.opt_v.momentum),
        round=np.asarray(sj.round))
    for P, b in round_inputs(arch)[1]:
        Pt = topology.SparseTopology(torch.as_tensor(np.asarray(P.idx)),
                                     torch.as_tensor(np.asarray(P.w)))
        bt = {k: {n: torch.as_tensor(a).long() if a.dtype == np.int32
                  else torch.as_tensor(a) for n, a in v.items()}
              for k, v in b.items()}
        state, _ = algo.round_fn_flat(state, Pt, bt, fl)
    return {"mom_u": state.opt_u.momentum.numpy()}


def rounds_job(arch: str):
    meta = {"m": M, "tp": 2, "rounds": ROUNDS, "arch": arch,
            "gossip": "matrix", "n_neighbors": 1, "topology": "random"}
    return "rounds", meta, round_inputs(arch)[0]


def check_rounds(got, arch):
    arrays, want = round_inputs(arch)[0], reference_rounds(arch)
    assert set(got) == set(want)
    for k in want:
        gap = KNOWN_GAP.get((arch, k))
        if gap is not None:
            np.testing.assert_allclose(got[k], port_rounds(arch)[k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=ATOL if gap is None else gap,
                                   err_msg=k)
    np.testing.assert_array_equal(got["mu"], want["mu"])
    # the rounds trained and mixed: the shared part left its init
    assert np.abs(got["flat"] - arrays["flat"]).max() > 1e-4


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """A gloo group of two ranks, the rounds at (1, 2), and one of four,
    the rounds at (2, 2) and the losses at (1, 4), side by side; the
    reference's side computed while they run."""
    two = {"rounds_" + arch: rounds_job(arch) for arch in ROUND_ARCHS}
    four = {"data2_" + DATA2: rounds_job(DATA2)}
    for arch in MODEL4:
        four["model4_" + arch] = loss_job(arch, 4, {})
    handles = [start_jobs(tmp_path_factory, 2, two),
               start_jobs(tmp_path_factory, 4, four)]
    out = {}
    try:
        for arch in ROUND_ARCHS:
            reference_rounds(arch)
        for arch in MODEL4:
            loss_case(arch)
    finally:
        for handle in handles:
            out.update(finish_jobs(handle))
    return out


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_resident_rounds_data1_model2_match_reference(groups, arch):
    check_rounds(groups["rounds_" + arch], arch)


def test_resident_rounds_data2_model2_match_reference(groups):
    check_rounds(groups["data2_" + DATA2], DATA2)


@pytest.mark.parametrize("arch", MODEL4)
def test_tp_loss_and_gradients_at_model_4_match_reference(groups, arch):
    check_loss(groups["model4_" + arch], arch, {})


# The reference's resident rounds in f64 from the arrays of IN.npz (the
# initial state and the rounds' inputs, `round_inputs`) -> OUT.npz
# "mom_u".  jax runs with x64, and the float32 that the reference's
# modules name (the mLSTM / sLSTM state, norms, the loss, mu and the
# table weights) reads float64 through a stand-in for their `jnp`; no
# file of the reference changes.
F64_ROUNDS = """
import sys, types, importlib
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp

class F64(types.ModuleType):
    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)

for name in ("models.ssm", "models.layers", "models.dense", "core.dfedpgp",
             "core.gossip", "core.topology", "launch.steps"):
    importlib.import_module("repro." + name).jnp = F64("jnp")
from repro.configs import get_reduced
from repro.core.topology import SparseTopology
from repro.launch import steps
from repro.models import get_model
from repro.spec import make_algo_spec

arch, m, b, rounds = sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), \
    int(sys.argv[6])
d = dict(np.load(sys.argv[1]))
cfg = get_reduced(arch).replace(compute_dtype="float64",
                                param_dtype="float64")
spec = make_algo_spec("dfedpgp", topology="random", n_neighbors=1, seed=0,
                      gossip="matrix", resident=True)
algo, _, _, fl = steps.build_train_algo(
    cfg, None, steps.Layout(("data",), (), ("model",), (), m, b), lr=0.02,
    spec=spec)
api = get_model(cfg)
init = jax.vmap(lambda k: api.init_params(k, cfg))(
    jax.random.split(jax.random.PRNGKey(0), m))
state, fl = algo.init_flat(init, fl)

def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def load(tree, prefix):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(d[prefix + "/" + name(p)], jnp.float64),
        tree)

state = state._replace(
    flat=jnp.asarray(d["flat"], jnp.float64),
    personal=load(state.personal, "personal"),
    mu=jnp.asarray(d["mu"], jnp.float64),
    opt_u=state.opt_u._replace(momentum=jnp.asarray(d["mom_u"],
                                                    jnp.float64)),
    opt_v=state.opt_v._replace(momentum=load(state.opt_v.momentum,
                                             "mom_v")))
step = jax.jit(lambda s, P, bt: algo.round_fn_flat(s, P, bt, fl))
for t in range(rounds):
    P = SparseTopology(jnp.asarray(d[f"idx/{t}"]),
                       jnp.asarray(d[f"w/{t}"], jnp.float64))
    bt = {part: {n: jnp.asarray(d[f"b/{t}/{part}/{n}"])
                 for n in ("tokens", "labels")} for part in "vu"}
    state, _ = step(state, P, bt)
assert state.flat.dtype == state.opt_u.momentum.dtype == jnp.float64
np.savez(sys.argv[2], mom_u=np.asarray(state.opt_u.momentum))
"""


def test_xlstm_momentum_gap_is_f32_rounding(tmp_path):
    # xlstm-125m's known difference (KNOWN_GAP): the port's one-device f32
    # momentum after the rounds parts from the reference's by no more
    # than KNOWN_GAP, and by no more than the reference's own f32 rounds
    # part from their f64 evaluation; the port's is no farther from it
    arch = DATA2
    np.savez(tmp_path / "in.npz", **round_inputs(arch)[0])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", F64_ROUNDS,
                          str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz"), arch, str(M), str(B),
                          str(ROUNDS)], env=env, timeout=TIMEOUT,
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
    f64 = np.load(tmp_path / "out.npz")["mom_u"]
    port = port_rounds(arch)["mom_u"].astype(np.float64)
    ref = reference_rounds(arch)["mom_u"].astype(np.float64)
    gap = np.abs(port - ref).max()
    ref_err, port_err = np.abs(ref - f64).max(), np.abs(port - f64).max()
    assert 0 < gap <= KNOWN_GAP[(arch, "mom_u")]
    assert gap <= ref_err and port_err <= ref_err, (gap, ref_err,
                                                    port_err)
