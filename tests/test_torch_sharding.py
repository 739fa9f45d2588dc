"""The port's placement rules (`repro_torch.launch.sharding` and the
placements of `launch/steps.py`) against the reference's specs, as
tuples, leaf by leaf, for every arch on the single-pod (data 16, model 16)
and multi-pod (pod 2, data 16, model 16) meshes.

Both sides read shapes only: the port's meta-tensor structs and the
reference's `jax.eval_shape` structs of the full-width configs.  The rule
functions are called on the reference's `FakeMesh` pattern
(tests/test_sharding.py) and, where the reference builds `NamedSharding`s,
on a jax `AbstractMesh` of the same sizes (no devices); the port reads a
`mesh.MeshSpec` of them."""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro_torch import configs, tree
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import steps as tsteps


class FakeMesh:
    """shape / axis_names stand-in (the reference test's pattern)."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _meshes(kind):
    sizes = MESHES[kind]
    return (FakeMesh(sizes),
            AbstractMesh(tuple(sizes.values()), tuple(sizes)),
            tmesh.make_production_mesh(multi_pod=kind == "multi"))


@functools.lru_cache(maxsize=None)
def _structs(arch, kind, shape="train_4k"):
    """(port layout, port struct, reference struct) at full width."""
    _, _, tm = _meshes(kind)
    lay = tsteps.decide_layout(tm, arch, configs.SHAPES[shape])
    return (lay, tsteps.stacked_param_struct(configs.get_config(arch),
                                             lay.n_clients),
            jsteps.stacked_param_struct(jget_config(arch), lay.n_clients))


def _jpaths(tree_):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree_)[0]}


def _is_placement(x) -> bool:
    """A placement tuple (None, a name or a tuple of names per dim): the
    leaves of the port's placement trees, which `tree.paths` would walk
    into as tuple nodes."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and e and all(isinstance(a, str)
                                               for a in e))
        for e in x)


def _placements(spec_tree, prefix=()):
    if _is_placement(spec_tree):
        yield prefix, spec_tree
        return
    items = sorted(spec_tree.items()) if isinstance(spec_tree, dict) \
        else enumerate(spec_tree)
    for key, val in items:
        yield from _placements(val, prefix + (key,))


def _specs(tree_):
    """{path: spec tuple} of a tree of jax NamedShardings or tuples."""
    leaves = jax.tree.leaves(tree_, is_leaf=lambda x: hasattr(x, "spec"))
    if leaves and hasattr(leaves[0], "spec"):
        return {k: tuple(v.spec) for k, v in _jpaths(tree_).items()}
    return {tsharding.path_str(p): s for p, s in _placements(tree_)}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_spec_for_path_matches_reference(arch, kind):
    fake, _, _ = _meshes(kind)
    lay, tstruct, _ = _structs(arch, kind)
    tp = tsharding.axes_size(fake, lay.tp_axes)
    fs = tsharding.axes_size(fake, lay.fsdp_axes) if lay.fsdp_axes else 1
    n_sharded = 0
    for p, leaf in tree.paths(tstruct):
        path, shape = tsharding.path_str(p), tuple(leaf.shape[1:])
        got = tsharding.spec_for_path(path, shape, lay.tp_axes, tp,
                                      fsdp_axes=lay.fsdp_axes, fsdp_size=fs)
        want = jsharding.spec_for_path(path, shape, lay.tp_axes, tp,
                                       fsdp_axes=lay.fsdp_axes, fsdp_size=fs)
        assert got == tuple(want), path
        n_sharded += any(a is not None for a in got)
    assert n_sharded >= len(tree.leaves(tstruct)) // 2


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_params_shardings_match_reference(arch, kind):
    _, amesh, tm = _meshes(kind)
    lay, tstruct, jstruct = _structs(arch, kind)
    got = _specs(tsteps.params_shardings(tstruct, tm, lay))
    want = _specs(jsteps.params_shardings(jstruct, amesh,
                                          jsteps.Layout(*lay)))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_param_bytes_per_device_match_reference(arch, kind):
    # the dry run's arithmetic on both sides' structs and specs
    _, amesh, tm = _meshes(kind)
    lay, tstruct, jstruct = _structs(arch, kind)
    tspec = tsteps.params_shardings(tstruct, tm, lay)
    got = sum(leaf.numel() * leaf.element_size()
              // tsharding.shards(tree.get(tspec, p), tm)
              for p, leaf in tree.paths(tstruct))
    jspec = jsteps.params_shardings(jstruct, amesh, jsteps.Layout(*lay))
    want = 0
    for leaf, sh in zip(jax.tree.leaves(jstruct), jax.tree.leaves(jspec)):
        n = 1
        for ax in jax.tree.leaves(tuple(sh.spec)):
            if ax is not None:
                n *= amesh.shape[ax]
        want += leaf.size * leaf.dtype.itemsize // n
    assert got == want


@pytest.mark.parametrize("d_flat", [494_031_872, 13_328, 49_155, 0])
@pytest.mark.parametrize("kind,client_axes,tp_axes", [
    ("single", ("data",), ("model",)), ("single", (), ("model",)),
    ("single", ("data",), ()), ("multi", ("pod", "data"), ("model",)),
    ("multi", ("pod",), ("data", "model")), ("multi", ("data",), ())])
def test_buffer_specs_match_reference(kind, d_flat, client_axes, tp_axes):
    fake, _, tm = _meshes(kind)
    assert tsharding.flat_buffer_spec(tm, client_axes, d_flat, tp_axes) == \
        tuple(jsharding.flat_buffer_spec(fake, client_axes, d_flat,
                                         tp_axes))
    for n_act in (1, 8, 16, 32, 25):
        assert tsharding.sampled_buffer_spec(
            tm, client_axes, n_act, d_flat, tp_axes) == tuple(
            jsharding.sampled_buffer_spec(fake, client_axes, n_act, d_flat,
                                          tp_axes))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_batch_specs_match_reference(arch, kind):
    _, amesh, tm = _meshes(kind)
    lay = _structs(arch, kind)[0]
    for shape, n_lead, key in (("train_4k", 2, "batches"),
                               ("prefill_32k", 1, "batch")):
        tb = tsteps.input_specs(configs.get_config(arch),
                                configs.SHAPES[shape], lay)[key]
        jb = jsteps.input_specs(jget_config(arch), JSHAPES[shape],
                                jsteps.Layout(*lay))[key]
        got = _specs(tsteps.batch_specs(tb, tm, lay, n_lead))
        want = _specs(jsteps.batch_specs(jb, amesh, jsteps.Layout(*lay),
                                         n_lead))
        assert got == want, shape
        # sharding.batch_sharding: the leading dim over the client axes
        got = _specs(tsharding.batch_sharding(tb, tm, lay.client_axes
                                              or ("data",)))
        want = _specs(jsharding.batch_sharding(jb, amesh, lay.client_axes
                                               or ("data",)))
        assert got == want, shape


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_cache_specs_match_reference(arch, kind):
    _, amesh, tm = _meshes(kind)
    shape = "long_500k" if arch in configs.LONG_CONTEXT_ARCHS \
        else "decode_32k"
    lay = tsteps.decide_layout(tm, arch, configs.SHAPES[shape])
    jlay = jsteps.Layout(*lay)
    tc = tsteps.input_specs(configs.get_config(arch), configs.SHAPES[shape],
                            lay)["cache"]
    jc = jsteps.input_specs(jget_config(arch), JSHAPES[shape],
                            jlay)["cache"]
    assert _specs(tsteps.cache_shardings(tc, tm, lay)) == \
        _specs(jsteps.cache_shardings(jc, amesh, jlay))
    ba = lay.client_axes or ("data",)
    assert _specs(tsharding.cache_sharding(tc, tm, ba, lay.tp_axes)) == \
        _specs(jsharding.cache_sharding(jc, amesh, ba, lay.tp_axes))
    assert set(_specs(tsharding.replicated(tc, tm)).values()) == {()}


def _flatten_specs(obj, prefix=""):
    """{name: spec tuple} over a step's in/out placement structure: the
    port's tuples, or the reference's NamedShardings."""
    if obj is None:
        return {}
    if hasattr(obj, "spec"):
        return {prefix: tuple(obj.spec)}
    if isinstance(obj, tuple) and not hasattr(obj, "_fields") and \
            all(a is None or isinstance(a, (str, tuple)) for a in obj):
        return {prefix: obj}
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    else:
        items = enumerate(obj)
    out = {}
    for k, v in items:
        out.update(_flatten_specs(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-125m",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("resident", [False, True])
def test_train_step_placements_match_reference(arch, kind, resident):
    _, amesh, tm = _meshes(kind)
    lay = tsteps.decide_layout(tm, arch, configs.SHAPES["train_4k"])
    from repro.core import topology as jtopology
    from repro_torch.core import topology as ttopology
    tkw = jkw = {}
    if resident:
        tkw = dict(resident=True, schedule=ttopology.get_schedule(
            "random", lay.n_clients, 3, 0))
        jkw = dict(resident=True, schedule=jtopology.TopologySchedule.random(
            lay.n_clients, 3, seed=0))
    with pytest.warns(DeprecationWarning) if resident else _quiet():
        _, tins, touts, _ = tsteps.build_train_step(
            configs.get_config(arch), tm, lay, configs.SHAPES["train_4k"],
            **tkw)
    with pytest.warns(DeprecationWarning) if resident else _quiet():
        _, jins, jouts, _ = jsteps.build_train_step(
            jget_config(arch), amesh, jsteps.Layout(*lay),
            JSHAPES["train_4k"], **jkw)
    assert _flatten_specs(tins) == _flatten_specs(jins)
    assert _flatten_specs(touts) == _flatten_specs(jouts)


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("step", ["prefill_32k", "decode_32k"])
def test_serve_step_placements_match_reference(kind, step):
    _, amesh, tm = _meshes(kind)
    arch = "qwen2-0.5b"
    lay = tsteps.decide_layout(tm, arch, configs.SHAPES[step])
    build_t = tsteps.build_prefill_step if step.startswith("prefill") \
        else tsteps.build_decode_step
    build_j = jsteps.build_prefill_step if step.startswith("prefill") \
        else jsteps.build_decode_step
    _, tins, tout, _ = build_t(configs.get_config(arch), tm, lay,
                               configs.SHAPES[step])
    _, jins, jout, _ = build_j(jget_config(arch), amesh, jsteps.Layout(*lay),
                               JSHAPES[step])
    assert _flatten_specs(tins) == _flatten_specs(jins)
    assert _flatten_specs(tout) == _flatten_specs(jout)


def test_one_device_steps_keep_none_placements():
    lay = tmesh.one_device_layout(4, 2)
    cfg = configs.get_reduced("qwen2-0.5b")
    shape = configs.SHAPES["decode_32k"]
    _, ins, outs, _ = tsteps.build_decode_step(cfg, None, lay, shape)
    assert ins == (None,) * 4 and outs == (None, None)


class _quiet:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
