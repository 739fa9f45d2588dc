"""Tensor parallelism across ranks for the hybrid, moe, ssm and encdec
families (`repro_torch.launch.tp`, `models/{hybrid,moe,ssm,encdec}.py`
with `tp=`) against the JAX reference.

- the shard plan of every leaf of recurrentgemma-9b, deepseek-moe-16b,
  deepseek-v2-236b, xlstm-125m and whisper-large-v3 at full width (meta
  tensors) at T 2, 4 and 16 is the reference's `spec_for_path` placement
  (plans only: the T the forward refuses are in); the shards of the
  `reduced()` models put back together give each leaf bit for bit;
- `check_tp` accepts every T that divides the query heads (and, for moe,
  the experts) of the five full configs and refuses the others, and a
  relocated split the forward does not cut, naming the leaf and the dim;
- at T = 1 in this process (a one-rank gloo group): each family's
  executor loss and every gradient are the plain `loss_fn`'s bit for
  bit, and 2 resident rounds through a one-rank client mesh are the
  one-device rounds bit for bit;
- at (data 1, model 2) in one gloo group of two ranks (subprocesses of
  `python -m repro_torch.launch.ranks_check`): the loss and every leaf's
  gradient, the shards put back together, against `jax.value_and_grad`
  of the reference's `loss_fn` on the same numpy inputs and the
  reference's init (its zero biases given values), at the dense family's
  f32 tolerance.  tests/test_torch_tp_families_rounds.py holds the rounds
  and the four-rank cases."""
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.launch import sharding as jsharding
from repro.models import get_model as jget_model
from repro_torch import configs, tree
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks as tranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import tp as ttp
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget_model
from test_torch_tp import (GRAD_TOL, LOSS_TOL, _leaves, flat_paths,
                           jobs)

FAMILY_ARCHS = ("recurrentgemma-9b", "deepseek-moe-16b", "deepseek-v2-236b",
                "xlstm-125m", "whisper-large-v3")
# S 32: two of xlstm's reduced mLSTM chunks (16) and past recurrentgemma's
# reduced local window (16)
B, S = 2, 32
# the reference compiled without XLA's excess precision, as
# tests/test_torch_ssm.py and tests/test_torch_moe.py compile it
EXACT = {"xla_allow_excess_precision": False}
torch.set_num_threads(4)


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _template(arch: str):
    return tree.tree_map(lambda a: a[0], tsteps.stacked_param_struct(
        configs.get_config(arch), 1))


@pytest.mark.parametrize("T", [2, 4, 16])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_shard_plan_is_the_reference_placement(arch, T):
    template = _template(arch)
    plan = ttp.shard_plan(template, T)
    assert set(plan) == {p for p, _ in tree.paths(template)}
    for path, leaf in tree.paths(template):
        spec = tuple(jsharding.spec_for_path(
            "/".join(map(str, path)), tuple(leaf.shape), ("model",), T))
        want = spec.index("model") if "model" in spec else None
        assert plan[path] == want, (path, spec)
        if want is not None:
            assert leaf.shape[want] % T == 0


def test_shard_plan_splits_each_family_where_its_forward_cuts():
    hyb = ttp.shard_plan(_template("recurrentgemma-9b"), 2)
    # the one MQA head's K / V cut inside it (256 columns), the query
    # heads whole; the RG-LRU over its channels
    assert hyb[("period_attn", "attn", "wk")] == 2
    assert hyb[("period_lru", "rec", "w_a")] == 3
    assert hyb[("period_lru", "rec", "lam")] == 2
    moe = ttp.shard_plan(_template("deepseek-moe-16b"), 4)
    assert moe[("moe_layers", "moe", "wg")] == 1           # the experts
    assert moe[("moe_layers", "moe", "router")] is None
    mla = ttp.shard_plan(_template("deepseek-v2-236b"), 4)
    assert mla[("moe_layers", "attn", "wq_a")] == 2
    assert mla[("moe_layers", "attn", "wkv_b")] == 2        # heads
    assert mla[("moe_layers", "attn", "wkv_a")] is None
    ssm = ttp.shard_plan(_template("xlstm-125m"), 2)
    assert ssm[("layers", 0, "w_up")] == 1
    assert ssm[("layers", 0, "w_if")] is None
    assert ssm[("layers", 3, "r_gates")] == 0
    # the sLSTM MLP's hidden width 2,047 is odd: relocated to d_model
    assert ssm[("layers", 3, "mlp", "wg")] == 0
    assert ssm[("layers", 3, "mlp", "wd")] == 1
    enc = ttp.shard_plan(_template("whisper-large-v3"), 4)
    # vocab 51,866 at T 4 relocates embed and lm_head to d_model
    assert (enc[("embed",)], enc[("lm_head",)]) == (1, 0)
    assert enc[("dec_layers", "mlp", "b2")] is None
    assert enc[("dec_layers", "cross_attn", "wv")] == 2


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_shards_put_back_together_bitwise(arch, T):
    cfg = configs.get_reduced(arch)
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
# check_tp
# ---------------------------------------------------------------------------
ACCEPTED = {"recurrentgemma-9b": (2, 4, 8, 16),
            "deepseek-moe-16b": (2, 4, 8, 16),
            "deepseek-v2-236b": (2, 4, 8, 16, 32),
            "xlstm-125m": (2, 4),
            "whisper-large-v3": (2, 4, 5, 10, 20)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_check_tp_accepts_every_t_that_divides_heads_and_experts(arch):
    cfg = configs.get_config(arch)
    for T in range(1, 33):
        ok = T in ACCEPTED[arch] + (1,)
        assert ok == (cfg.n_heads % T == 0 and (cfg.n_experts or T) % T
                      == 0), T
        if ok:
            ttp.check_tp(cfg, T, _template(arch))
        else:
            with pytest.raises(ValueError, match=r"does not divide n_heads"
                               r"|does not divide n_experts"):
                ttp.check_tp(cfg, T, _template(arch))


@pytest.mark.parametrize("arch,replace,T,match", [
    ("xlstm-125m", {}, 16, r"does not divide n_heads=4 of xlstm-125m.*"
     r"leaf layers/0/wq \(1536, 1536\), dim 1"),
    ("whisper-large-v3", {}, 3, r"does not divide n_heads=20.*"
     r"leaf \S+/wq \(32, 1280, 1280\), dim 2"),
    ("deepseek-moe-16b", {"n_experts": 6}, 4,
     r"does not divide n_experts=6.*leaf moe_layers/moe/wg \(1, 6, 128, "
     r"64\), dim 1"),
    ("recurrentgemma-9b", {"lru_width": 129}, 2,
     r"leaf period_lru/rec/b_a \(1, 2, 129\): the plan replicates it, where "
     r"the forward splits dim 2 \(129, not a multiple of 2\)"),
    ("whisper-large-v3", {"d_ff": 258}, 4,
     r"leaf dec_layers/mlp/b1 \(2, 258\): the plan replicates it, where the "
     r"forward splits dim 1"),
    ("deepseek-v2-236b", {"q_lora": 49}, 2,
     r"leaf dense_layers/attn/wq_a \(1, 128, 49\): the plan splits its dim "
     r"1 \(128\), where the forward splits dim 2 \(49"),
    ("deepseek-v2-236b", {"q_lora": 0}, 2, r"MLA without q_lora.*"
     r"leaf \S+/attn/wq \(1, 128, 4, 24\), dim 3")])
def test_check_tp_refuses_a_split_the_forward_does_not_run(arch, replace, T,
                                                            match):
    base = configs.get_config(arch) if not replace else \
        configs.get_reduced(arch)
    cfg = base.replace(**replace)
    with pytest.raises(ValueError, match=match):
        ttp.check_tp(cfg, T)


# ---------------------------------------------------------------------------
# T = 1 in this process: the executor is the plain path bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank():
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="tp_families_one_rank_")
    tranks.init(0, 1, os.path.join(tmp, "rendezvous"), "cpu")
    try:
        yield tmesh.make_host_mesh(4, model=1)
    finally:
        dist.destroy_process_group()


def _batch(cfg, lead, seed=3):
    """Numpy tokens / labels (and an encdec's frames) with leading dims
    `lead`."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, tuple(lead) + (S,)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, -1)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            tuple(lead) + (cfg.n_frames, cfg.d_model)).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_one_rank_loss_and_gradients_are_the_plain_ones_bitwise(
        one_rank, arch, remat):
    cfg = configs.get_reduced(arch).replace(remat=remat)
    api = tget_model(cfg)
    params = tree.tree_map(lambda a: torch.stack([a, a * 0.5]),
                           api.init_params(torch.Generator().manual_seed(2),
                                           cfg, device="cpu"))
    batch = _torch_batch(_batch(cfg, (2, B)))
    shards = ttp.Executor(cfg, one_rank, tree.tree_map(lambda a: a[0],
                                                       params))
    fn = torch.func.vmap(torch.func.grad_and_value(shards.loss_fn(api,
                                                                  cfg)))
    plain = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: api.loss_fn(p, b, cfg)))
    (g, loss), (g0, loss0) = fn(shards.shard(params), batch), \
        plain(params, batch)
    assert torch.equal(loss, loss0)
    for path, x in tree.paths(g0):
        assert torch.equal(tree.get(g, path), x), path


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v2-236b",
                                  "xlstm-125m", "whisper-large-v3"])
def test_one_rank_rounds_are_the_one_device_rounds_bitwise(one_rank, arch):
    argv = ["--arch", arch, "--reduced", "--clients", "4", "--batch",
            str(B), "--seq", str(S), "--device", "cpu", "--resident",
            "--topology", "exponential"]
    ap = ttrain.build_parser()
    one = ttrain.Trainer(ap.parse_args(argv), ap)
    mesh = ttrain.Trainer(ap.parse_args(argv), ap, one_rank)
    assert mesh.algo.tp is not None and one.algo.tp is None
    for r in range(2):
        b = one.batches(r)
        one.step(r, b)
        mesh.step(r, b)
    want, got = _leaves(one.state), _leaves(mesh.state)
    assert want.keys() == got.keys()
    for k, x in want.items():
        assert torch.equal(got[k], x), k


# ---------------------------------------------------------------------------
# (data 1, model 2) on gloo: the loss and every gradient
# ---------------------------------------------------------------------------
def jcfg(arch, **replace):
    return jget_reduced(arch).replace(compute_dtype="float32", **replace)


def _with_biases(params, seed):
    """The reference's init with its zero-initialized biases and offsets
    (LayerNorm b, b1, b2, b_a, b_i, b_gates, b_if) moved off zero, so that
    the forward reads them."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.startswith("b") and a.ndim >= 1:
            return a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(one, params)


@functools.lru_cache(maxsize=None)
def loss_inputs(arch, **replace):
    """(config, the reference's init of two clients, their batch)."""
    cfg = jcfg(arch, **replace)
    api = jget_model(cfg)
    params = jax.vmap(lambda k: api.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    params = _with_biases(jax.tree.map(np.asarray, params), 4)
    return cfg, params, _batch(cfg, (2, B), seed=5)


@functools.lru_cache(maxsize=None)
def loss_case(arch, **replace):
    """((2,) reference losses, reference gradients by path)."""
    cfg, params, batch = loss_inputs(arch, **replace)
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        functools.partial(jget_model(cfg).loss_fn, cfg=cfg))),
        compiler_options=EXACT)
    loss, grads = vg(jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, batch))
    return np.asarray(loss), flat_paths(grads, "grad")


def loss_job(arch, T, replace):
    _, params, batch = loss_inputs(arch, **replace)
    meta = {"m": 2, "tp": T, "arch": arch, "cfg": replace}
    return "tp_loss", meta, dict(flat_paths(params, "params"), **batch)


def check_loss(got, arch, replace):
    loss, grads = loss_case(arch, **replace)
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert {k for k in got if k.startswith("grad/")} == set(grads)
    for k, want in grads.items():
        np.testing.assert_allclose(got[k], want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    """One gloo group of two ranks, (data 1, model 2): the five models'
    losses and gradients; the reference's computed while it runs."""
    todo = {arch: loss_job(arch, 2, {}) for arch in FAMILY_ARCHS}
    meanwhile = [functools.partial(loss_case, arch)
                 for arch in FAMILY_ARCHS]
    return jobs(tmp_path_factory, 2, todo, meanwhile)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tp_loss_and_gradients_match_reference(group2, arch):
    check_loss(group2[arch], arch, {})
