"""`remat` (`repro_torch.models.remat`): each family's blocks rematerialized
on the training route under `cfg.remat`, at reduced().

- The loss and the `vmap(grad_and_value)` gradients of two stacked
  clients (the rounds' transform) with remat=True equal the port's
  remat=False bit for bit on the CPU, in f32 and bf16: the backward
  replays the same operations (whisper's decoder takes its one use of
  the encoder output per block in both forms, `encdec._dec_block`).
- They match the reference's remat=True gradient (`jax.checkpoint` of
  each block) at the family's f32 tolerance of its own gradient test,
  the reference run as that test runs it: rtol 1e-4 / atol 1e-6 for
  dense (eager) and vlm (jitted), rtol = atol = 5e-5 for moe, ssm,
  encdec and hybrid (jitted without XLA's excess precision).
- A counter on each family's block function shows the block's forward
  runs twice under remat (the forward and the backward's replay) and
  once without, and once on the kernel route whatever the flag."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import get_reduced as jget_reduced
from repro.models import get_model as jget_model
from repro_torch import convert, tree
from repro_torch.configs import get_reduced
from repro_torch.launch.train import init_stacked, synth_lm_batch
from repro_torch.models import (dense, encdec, get_model, hybrid, moe, remat,
                                ssm, vlm)

torch.set_num_threads(2)
ARCHS = ("qwen2-0.5b", "recurrentgemma-9b", "deepseek-moe-16b",
         "deepseek-v2-236b", "qwen2-vl-7b", "xlstm-125m", "whisper-large-v3")
TOL = {"qwen2-0.5b": (1e-4, 1e-6), "qwen2-vl-7b": (1e-4, 1e-6)}
DEFAULT_TOL = (5e-5, 5e-5)
EXACT = {"xla_allow_excess_precision": False}
S = 16
# the functions each family's training forward runs once per block
BLOCKS = {"qwen2-0.5b": [(dense, "_block")],
          "recurrentgemma-9b": [(hybrid, "_period_fwd")],
          "deepseek-moe-16b": [(moe, "_dense_block"), (moe, "_moe_block")],
          "deepseek-v2-236b": [(moe, "_dense_block"), (moe, "_moe_block")],
          "qwen2-vl-7b": [(vlm, "_block")],
          "xlstm-125m": [(ssm, "mlstm_block"), (ssm, "slstm_block")],
          "whisper-large-v3": [(encdec, "_enc_block"),
                               (encdec, "_dec_block")]}


def _cfg(arch, cdtype="float32", on=True):
    return get_reduced(arch).replace(compute_dtype=cdtype, remat=on)


def _n_blocks(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // 3
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_plain_bitwise(arch, cdtype):
    cfg = _cfg(arch, cdtype)
    api = get_model(cfg)
    params = init_stacked(cfg, 2, "cpu")
    batch = synth_lm_batch(torch.Generator().manual_seed(1), cfg, (2, 2), S)
    outs = []
    for on in (False, True):
        c = cfg.replace(remat=on)
        outs.append(vmap(grad_and_value(
            lambda p, b: api.loss_fn(p, b, c)))(params, batch))
    (g0, l0), (g1, l1) = outs
    assert torch.equal(l0, l1)
    for (p, a), b in zip(tree.paths(g0), tree.leaves(g1)):
        assert torch.equal(a, b), p


def _reference_grad(arch):
    """(port gradient, reference gradient) of one client's f32 loss with
    remat=True on both sides, from the reference's init."""
    cfg_j = jget_reduced(arch).replace(compute_dtype="float32", remat=True)
    cfg_t = _cfg(arch)
    jp = jax.jit(lambda k: jget_model(cfg_j).init_params(k, cfg_j))(
        jax.random.PRNGKey(0))
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp))
    tb = synth_lm_batch(torch.Generator().manual_seed(3), cfg_t, (2,), S)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype ==
                         torch.int64 else v.numpy()) for k, v in tb.items()}

    def grad(p, b):
        return jax.grad(jget_model(cfg_j).loss_fn)(p, b, cfg_j)

    # the reference run as the family's own gradient test runs it
    jg = {"dense": grad, "vlm": jax.jit(grad)}.get(
        cfg_j.family, jax.jit(grad, compiler_options=EXACT))(jp, jb)
    tg = torch.func.grad(get_model(cfg_t).loss_fn)(tp, tb, cfg_t)
    return tg, jg


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradient_matches_reference(arch):
    tg, jg = _reference_grad(arch)
    rtol, atol = TOL.get(arch, DEFAULT_TOL)
    for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        np.testing.assert_allclose(tree.get(tg, key).numpy(), np.asarray(x),
                                   rtol=rtol, atol=atol, err_msg=str(p))


def _counting(monkeypatch, arch):
    calls = []
    for mod, name in BLOCKS[arch]:
        real = getattr(mod, name)

        def counted(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("on", [False, True])
def test_remat_replays_each_block_once(arch, on, monkeypatch):
    cfg = _cfg(arch, on=on)
    api = get_model(cfg)
    params = init_stacked(cfg, 1, "cpu")
    batch = synth_lm_batch(torch.Generator().manual_seed(2), cfg, (1, 2), S)
    calls = _counting(monkeypatch, arch)
    vmap(grad_and_value(lambda p, b: api.loss_fn(p, b, cfg)))(params, batch)
    assert len(calls) == _n_blocks(cfg) * (2 if on else 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_never_rematerializes(arch, monkeypatch):
    # prefill takes the kernel route: one forward per block, no Function
    cfg = _cfg(arch)
    params = tree.tree_map(lambda a: a[0], init_stacked(cfg, 1, "cpu"))
    batch = synth_lm_batch(torch.Generator().manual_seed(2), cfg, (2,), S)
    batch.pop("labels")
    calls = _counting(monkeypatch, arch)
    applied = []
    monkeypatch.setattr(remat, "call", lambda *a: applied.append(a))
    from repro_torch.models import prefill_logits
    with torch.no_grad():
        prefill_logits(params, batch, cfg)
    assert len(calls) == _n_blocks(cfg) and not applied


def test_enabled_reads_the_flag_and_the_route():
    cfg = get_reduced("qwen2-0.5b")
    assert not remat.enabled(cfg, "plain")
    assert remat.enabled(cfg.replace(remat=True), "plain")
    assert not remat.enabled(cfg.replace(remat=True), "kernel")


def test_call_passes_trees_ints_and_tuples():
    # a block of a tree, an int index tensor and a constant, returning a
    # tuple: gradients of every float input equal the plain block's
    def block(p, x, idx, scale):
        y = torch.tanh(x @ p["w"] + p["b"])[:, idx]
        return y * scale, (y ** 2).sum()

    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(3, 4, 5, generator=gen),
         "b": torch.randn(3, 5, generator=gen)}
    x = torch.randn(3, 2, 4, generator=gen)
    idx = torch.tensor([0, 1])

    def loss(fn):
        def f(p, x):
            y, s = fn(block, p, x, idx, 0.5)
            return y.sum() + s
        return vmap(grad_and_value(f, argnums=(0, 1)))(p, x)

    (gp0, gx0), l0 = loss(lambda b, *a: b(*a))
    (gp1, gx1), l1 = loss(remat.call)
    assert torch.equal(l0, l1) and torch.equal(gx0, gx1)
    assert all(torch.equal(gp0[k], gp1[k]) for k in gp0)
