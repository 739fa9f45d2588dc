"""The port's launch package (`repro_torch.launch`) against the
reference's `repro.launch`: the schedule's permutation offsets, the layout
arithmetic on the production meshes' descriptions, the input structs,
`build_train_step`'s refusals, the prefill and decode steps, the
`train.py` trainer's record lines and JSONL, and the training route's
gradient through the dense LM."""
import dataclasses
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import topology as jtopology
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import dense as jdense
from repro.obs import report as jreport
from repro_torch import configs, convert, tree
from repro_torch.core import topology as ttopology
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import dense as tdense
from repro_torch.obs import record as trecord
from repro_torch.obs import report as treport

torch.set_num_threads(2)
JMESH = jax.make_mesh((1, 1), ("data", "model"))
TMESH = tmesh.mesh_spec((1, 1), ("data", "model"))
DENSE = ("qwen2-0.5b", "h2o-danube-1.8b", "granite-3-2b", "codeqwen1.5-7b")


def _shape(name, **kw):
    return dataclasses.replace(configs.SHAPES[name], **kw)


def _jshape(name, **kw):
    return dataclasses.replace(jconfigs.SHAPES[name], **kw)


# ---------------------------------------------------------------------------
# the schedule's permutation offsets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("kind", ["exponential", "ring"])
def test_permutation_offsets_match_reference(kind, m):
    want = getattr(jtopology.TopologySchedule, kind)(m).permutation_offsets()
    got = ttopology.get_schedule(kind, m).permutation_offsets()
    assert got == want
    assert got == ((1,) if kind == "ring"
                   else tuple(2 ** t for t in range(int(np.log2(m)))))


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("kind", ["random", "full"])
def test_permutation_offsets_refuse_other_mixes(kind, m):
    jsched = jtopology.get_schedule(kind, m, 2, 0)
    with pytest.raises(ValueError) as jerr:
        jsched.permutation_offsets()
    with pytest.raises(ValueError) as terr:
        ttopology.get_schedule(kind, m, 2, 0).permutation_offsets()
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# layouts on the production meshes' descriptions
# ---------------------------------------------------------------------------
def _production(multi_pod):
    """The reference's production meshes (launch/mesh.py): (data 16,
    model 16) = 256 chips, (pod 2, data 16, model 16) = 512."""
    if multi_pod:
        return tmesh.mesh_spec((2, 16, 16), ("pod", "data", "model"))
    return tmesh.mesh_spec((16, 16), ("data", "model"))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_decide_layout_matches_reference(multi_pod):
    # the reference's functions read only axis names and sizes, so both
    # take the same description of the 256- and 512-chip meshes
    mesh = _production(multi_pod)
    seen = set()
    for arch in jconfigs.ARCH_IDS:
        for name in configs.SHAPES:
            got = tsteps.decide_layout(mesh, arch, configs.SHAPES[name])
            want = jsteps.decide_layout(mesh, arch, jconfigs.SHAPES[name])
            assert tuple(got) == tuple(want), (arch, name)
            seen.add("fsdp" if got.fsdp_axes else "clients")
    assert seen == {"fsdp", "clients"}
    # the FSDP arch and long_500k's batch of one
    dsv2 = tsteps.decide_layout(mesh, "deepseek-v2-236b",
                                configs.SHAPES["train_4k"])
    assert dsv2.fsdp_axes == ("data",) and \
        dsv2.n_clients == (2 if multi_pod else 1)
    long = tsteps.decide_layout(mesh, "h2o-danube-1.8b",
                                configs.SHAPES["long_500k"])
    assert long.n_clients == 1 and long.client_axes == ()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("strategy", ["auto", "data_clients", "pod_clients"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b"])
def test_client_layout_matches_reference(multi_pod, strategy, arch):
    mesh = _production(multi_pod)
    if strategy == "pod_clients" and not multi_pod:
        for fn in (tmesh.client_layout, jmesh.client_layout):
            with pytest.raises(ValueError, match="multi-pod"):
                fn(mesh, strategy, arch)
        return
    assert tmesh.client_layout(mesh, strategy, arch) == \
        jmesh.client_layout(mesh, strategy, arch)


# ---------------------------------------------------------------------------
# input structs and build_train_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "deepseek-v2-236b",
                                  "qwen2-vl-7b"])
def test_stacked_param_struct_matches_reference(arch):
    # the full-width configs: shapes only on both sides (eval_shape, meta)
    got = tsteps.stacked_param_struct(configs.get_config(arch), 4)
    want = jsteps.stacked_param_struct(jconfigs.get_config(arch), 4)
    jp = {tuple(k.key for k in p): (tuple(x.shape), str(x.dtype))
          for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in tree.paths(got)} == jp
    assert all(x.is_meta for x in tree.leaves(got))


@pytest.mark.parametrize("resident", [False, True])
def test_train_step_structs_match_reference(resident):
    cfg_t, cfg_j = configs.get_reduced("qwen2-0.5b"), \
        jconfigs.get_reduced("qwen2-0.5b")
    shape_t, shape_j = (_shape("train_4k", seq_len=32, global_batch=2),
                        _jshape("train_4k", seq_len=32, global_batch=2))
    lay_t = tsteps.decide_layout(TMESH, cfg_t.arch_id, shape_t)
    lay_j = jsteps.decide_layout(JMESH, cfg_j.arch_id, shape_j)
    assert tuple(lay_t) == tuple(lay_j)
    kw = dict(resident=True, schedule=jtopology.TopologySchedule.random(
        lay_j.n_clients, 0, seed=3)) if resident else {}
    tkw = dict(resident=True, schedule=ttopology.get_schedule(
        "random", lay_t.n_clients, 0, 3)) if resident else {}
    with pytest.warns(DeprecationWarning) if resident else _nothing():
        fn, ins, outs, args, donate = tsteps.build_step(
            cfg_t, None, lay_t, shape_t, **tkw)
    with pytest.warns(DeprecationWarning) if resident else _nothing():
        jargs = jsteps.build_step(cfg_j, JMESH, lay_j, shape_j, **kw)[3]
    assert donate == (0,) and all(s is None for s in ins)
    assert all(x.is_meta for x in _tensors(args))
    # int64 tokens where the reference's are int32 (torch indexes an
    # embedding with int64); every other leaf the reference's
    got = [(tuple(x.shape), str(x.dtype).split(".")[-1].replace(
        "int64", "int32")) for x in _tensors(args)]
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jargs)]
    assert sorted(got) == sorted(want)
    if resident:
        assert args[0].flat.shape == jargs[0].flat.shape


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _tensors(v)]
    return []


def _refusal(build, case):
    cfg = configs.get_reduced("qwen2-0.5b")
    shape = _shape("train_4k", seq_len=32, global_batch=2)
    lay = tsteps.decide_layout(TMESH, "qwen2-0.5b", shape)
    if build is jsteps:
        cfg, mesh = jconfigs.get_reduced("qwen2-0.5b"), JMESH
        shape = _jshape("train_4k", seq_len=32, global_batch=2)
        lay = jsteps.Layout(*lay)
        ring = jtopology.TopologySchedule.ring
    else:
        mesh = None

        def ring(m):
            return ttopology.get_schedule("ring", m)
    kw = {"mismatch": dict(schedule=ring(lay.n_clients + 3)),
          "not_resident": dict(sample_frac=0.5, schedule=ring(1)),
          "no_schedule": dict(sample_frac=0.5, resident=True),
          "ppermute": dict(sample_frac=0.5, resident=True,
                           schedule=ring(1), gossip="ppermute"),
          "frac": dict(sample_frac=1.5)}[case]
    return build.build_train_step(cfg, mesh, lay, shape, **kw)


@pytest.mark.parametrize("case,err,match", [
    ("mismatch", AssertionError, "n_clients"),
    ("not_resident", ValueError, "resident=True"),
    ("no_schedule", ValueError, "pass schedule="),
    ("ppermute", ValueError, "ppermute offsets"),
    ("frac", ValueError, r"want \(0, 1\]")])
def test_build_train_step_refusals_match_reference(case, err, match):
    # the legacy kwargs (the reference's deprecated surface) on both sides
    caught = []
    for build in (jsteps, tsteps):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(err, match=match) as e:
                _refusal(build, case)
        caught.append(str(e.value))
    assert caught[0] == caught[1]


# ---------------------------------------------------------------------------
# prefill and decode steps
# ---------------------------------------------------------------------------
def test_prefill_and_decode_steps_match_reference():
    # the reference vmaps the clients; the port loops them (the flash
    # kernel cannot run under vmap) on the kernel route, f32 at reduced()
    m, B, S = 2, 2, 24
    cfg_j, cfg_t = (jconfigs.get_reduced("qwen2-0.5b"),
                    configs.get_reduced("qwen2-0.5b"))
    lay_j = jsteps.Layout(("data",), (), ("model",), (), m, B)
    lay_t = tmesh.one_device_layout(m, B)
    jp = jax.vmap(lambda k: jdense.init_params(k, cfg_j))(
        jax.random.split(jax.random.PRNGKey(1), m))
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, (m, B, S))
    pre_j = jsteps.build_prefill_step(cfg_j, JMESH, lay_j,
                                      _jshape("prefill_32k", seq_len=S,
                                              global_batch=m * B))[0]
    pre_t, ins, out, args = tsteps.build_prefill_step(
        cfg_t, None, lay_t, _shape("prefill_32k", seq_len=S,
                                   global_batch=m * B))
    assert out is None and args[1]["tokens"].shape == (m, B, S)
    got = pre_t(tp, {"tokens": torch.as_tensor(toks)})
    want = pre_j(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert got.shape == want.shape == (m, B, 1, cfg_t.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    dshape_t = _shape("decode_32k", seq_len=8, global_batch=m * B)
    dec_t, _, _, dargs = tsteps.build_decode_step(cfg_t, None, lay_t,
                                                  dshape_t)
    dec_j = jsteps.build_decode_step(
        cfg_j, JMESH, lay_j, _jshape("decode_32k", seq_len=8,
                                     global_batch=m * B))[0]
    cache_t = tree.tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype),
                            dargs[1])
    cache_j = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                           jsteps.input_specs(
                               cfg_j, _jshape("decode_32k", seq_len=8,
                                              global_batch=m * B),
                               lay_j)["cache"])
    for pos in range(3):
        tok = toks[:, :, pos:pos + 1]
        lt, cache_t = dec_t(tp, cache_t, torch.as_tensor(tok), pos)
        lj, cache_j = dec_j(jp, cache_j, jnp.asarray(tok, jnp.int32),
                            jnp.int32(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=5e-5,
                                   atol=5e-5)
    for name in cache_t:
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=5e-5,
                                   atol=5e-5)


# ---------------------------------------------------------------------------
# the trainer's entry point
# ---------------------------------------------------------------------------
ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--rounds", "1", "--clients",
        "4", "--batch", "2", "--seq", "32", "--neighbors", "2"]


def _shape_of(line: str) -> str:
    """A printed line with its numbers masked."""
    return re.sub(r"-?\d[\d,.e+-]*", "#", line)


# the sampled run on the ring: its induced tables are the same on both
# sides (the random kind's draws are not), so the wire meters agree
@pytest.mark.parametrize("extra", [[], ["--resident"],
                                   ["--resident", "--sample", "0.5",
                                    "--topology", "ring"],
                                   ["--gossip", "ppermute"]])
def test_train_main_prints_the_reference_lines(extra, capsys):
    jtrain.main(ARGV + extra)
    want = capsys.readouterr().out.splitlines()
    state = ttrain.main(ARGV + extra + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [_shape_of(x) for x in got] == [_shape_of(x) for x in want]
    # the size line (parameter counts) and the wire meter agree exactly
    head = [x for x in got if "params/client" in x]
    assert head == [x for x in want if "params/client" in x]
    wire = [re.search(r"wire_bytes=(\d+)", x).group(1) for x in got
            if "wire_bytes" in x]
    assert wire == [re.search(r"wire_bytes=(\d+)", x).group(1)
                    for x in want if "wire_bytes" in x]
    assert all(t.device.type == "cpu" for t in _tensors(state._asdict()))


def test_train_main_metrics_pass_both_reports(tmp_path, capsys):
    path = str(tmp_path / "trainB.jsonl")
    ttrain.main(ARGV + ["--rounds", "2", "--resident", "--telemetry",
                        "--graph-every", "1", "--metrics", path,
                        "--device", "cpu"])
    assert "metrics ->" in capsys.readouterr().out
    assert treport.main([path, "--check"]) == 0
    assert jreport.main([path, "--check"]) == 0
    kinds = [rec["kind"] for rec in trecord.load_jsonl(path)]
    assert kinds == ["round", "graph"] * 2


def test_train_main_targets_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(ARGV)


def test_synth_lm_batch_shifts_labels():
    cfg = configs.get_reduced("qwen2-0.5b")
    b = ttrain.synth_lm_batch(torch.Generator().manual_seed(0), cfg,
                              (3, 1, 2), 16)
    assert b["tokens"].shape == (3, 1, 2, 16) and b["tokens"].dtype == \
        torch.int64
    assert torch.equal(b["labels"][..., :-1], b["tokens"][..., 1:])
    assert int(b["tokens"].max()) < cfg.vocab


# ---------------------------------------------------------------------------
# the training route's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_gradient_matches_reference(arch):
    # the port's loss_fn takes the plain route (gqa_attend under the
    # causal mask, the reference's own branch below 2,048); its autograd
    # gradient against jax.grad of the reference's loss, f32, every leaf.
    # S 40 > danube's window 16: the band mask is differentiated too
    cfg_j, cfg_t = (jconfigs.get_reduced(arch), configs.get_reduced(arch))
    jp = jax.jit(jdense.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg_j)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(0, cfg_t.vocab, (2, 40))
    labels = np.roll(toks, -1, axis=1)
    jg = jax.grad(jdense.loss_fn)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}, cfg_j)
    tg = torch.func.grad(tdense.loss_fn)(
        tp, {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}, cfg_t)
    for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]:
        got = tree.get(tg, tuple(k.key for k in p)).numpy()
        np.testing.assert_allclose(got, np.asarray(x), rtol=1e-4, atol=1e-6,
                                   err_msg=str(p))
