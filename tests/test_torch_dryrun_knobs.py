"""The dry run's knobs (`python -m repro_torch.launch.dryrun` with the
reference's --k_u, --k_v, --bf16-grads, --bf16-params, --kv-quant,
--moe-shard, --gossip-dtype, --tag; --keep-hlo and --unroll refused):
each counted number that a knob moves is held against the reference's
own arithmetic on `jax.eval_shape` structs under its specs on an
`AbstractMesh` (nothing compiled), as `test_torch_dryrun.py` holds the
param bytes; a knob that moves no counted number is named in the
record's `knob_notes`.  Token ids are int64 in the port and int32 in the
reference: batch bytes are compared at the port's width."""
import dataclasses
import json

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import SHAPES
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro_torch.configs import SHAPES as SHAPES_T
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import one_device_layout

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
KNOBS = ("k_u", "k_v", "bf16_grads", "gossip_dtype", "kv_quant",
         "bf16_params", "moe_shard")


def _mesh(kind):
    sizes = MESHES[kind]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _per_device(struct, shardings, mesh, width=None) -> int:
    """The reference dry run's bytes per device of a struct under its
    shardings; `width` maps a dtype name to the port's item size."""
    total = 0
    for leaf, sh in zip(jax.tree.leaves(struct), jax.tree.leaves(shardings)):
        n = 1
        for ax in jax.tree.leaves(tuple(sh.spec)):
            if ax is not None:
                n *= mesh.shape[ax]
        size = (width or {}).get(leaf.dtype.name, leaf.dtype.itemsize)
        total += leaf.size * size // n
    return total


def _run(arch="qwen2-0.5b", shape="train_4k", mesh="single", **kw):
    return dryrun.run_one(arch, shape, mesh, out=None, flops=False, **kw)


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
    ("recurrentgemma-9b", "train_4k"), ("xlstm-125m", "prefill_32k")])
def test_bf16_params_match_the_reference_arithmetic(arch, shape_name):
    mesh = _mesh("single")
    lay = jsteps.decide_layout(mesh, arch, SHAPES[shape_name])
    cfg = jget_config(arch).replace(param_dtype="bfloat16")
    struct = jsteps.stacked_param_struct(cfg, lay.n_clients)
    want = _per_device(struct, jsteps.params_shardings(struct, mesh, lay),
                       mesh)
    f32, bf16 = _run(arch, shape_name), _run(arch, shape_name,
                                             bf16_params=True)
    assert bf16["bytes_per_device"]["params"] == want
    # the leaves that follow param_dtype halve (recurrentgemma keeps a
    # few f32 leaves in both packages)
    f32b = f32["bytes_per_device"]["params"]
    assert 2 * want >= f32b and 2 * want - f32b < f32b // 1000
    if arch == "qwen2-0.5b":
        assert 2 * want == f32b
    assert bf16["bf16_params"] is True and "bf16_params" not in \
        bf16["knob_notes"]


def test_bf16_params_reach_the_resident_state():
    # the port's steps build the buffer and its momentum in the params'
    # dtype: the state's bytes halve with the params'
    f32 = _run(resident=True)["bytes_per_device"]
    bf16 = _run(resident=True, bf16_params=True)["bytes_per_device"]
    assert bf16["params"] * 2 == f32["params"]
    assert abs(bf16["state"] * 2 - f32["state"]) <= 16 * 4   # mu, round


def test_kv_quant_decode_cache_matches_the_reference():
    mesh = _mesh("single")
    shape = SHAPES["decode_32k"]
    lay = jsteps.decide_layout(mesh, "qwen2-0.5b", shape)
    cfg = jget_config("qwen2-0.5b").replace(kv_quant=True)
    cache = jsteps.input_specs(cfg, shape, lay)["cache"]
    assert sorted(cache) == ["k", "k_s", "v", "v_s"]
    want = _per_device(cache, jsteps.cache_shardings(cache, mesh, lay), mesh)
    plain, quant = _run(shape="decode_32k"), _run(shape="decode_32k",
                                                  kv_quant=True)
    assert quant["bytes_per_device"]["cache"] == want
    assert quant["bytes_per_device"]["cache"] < \
        plain["bytes_per_device"]["cache"]
    assert quant["kv_quant"] is True and quant["knob_notes"] == {}


@pytest.mark.parametrize("arch,shape_name", [("xlstm-125m", "decode_32k"),
                                             ("qwen2-0.5b", "train_4k")])
def test_kv_quant_elsewhere_leaves_the_cache_and_says_why(arch,
                                                          shape_name):
    plain = _run(arch, shape_name)
    quant = _run(arch, shape_name, kv_quant=True)
    assert quant["status"] == "ok"
    assert quant["bytes_per_device"] == plain["bytes_per_device"]
    assert "dense family" in quant["knob_notes"]["kv_quant"]


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_k_u_k_v_batch_bytes_match_the_reference(kind):
    mesh = _mesh(kind)
    shape = SHAPES["train_4k"]
    lay = jsteps.decide_layout(mesh, "qwen2-0.5b", shape)
    cfg = jget_config("qwen2-0.5b")
    batches = jsteps.input_specs(cfg, shape, lay, k_u=2, k_v=3)["batches"]
    sh = jsteps.batch_specs(batches, mesh, lay, n_lead=2)
    want = _per_device(batches, sh, mesh, width={"int32": 8})
    rec = _run(mesh=kind, k_u=2, k_v=3)
    one = _run(mesh=kind)
    assert rec["bytes_per_device"]["batch"] == want
    assert 2 * rec["bytes_per_device"]["batch"] == \
        5 * one["bytes_per_device"]["batch"]
    assert (rec["k_u"], rec["k_v"]) == (2, 3)


def test_gossip_dtype_halves_the_wire():
    for resident in (False, True):
        f32 = _run(resident=resident)["wire"]
        bf16 = _run(resident=resident, gossip_dtype="bfloat16")
        assert bf16["gossip_dtype"] == "bfloat16"
        w = bf16["wire"]
        assert 2 * w["row_bytes_per_device"] == f32["row_bytes_per_device"]
        assert 2 * w["bytes_per_device"] == f32["bytes_per_device"]
        assert (w["rows_sent"], w["rows_received"]) == \
            (f32["rows_sent"], f32["rows_received"])


def test_k_u_about_doubles_the_shared_phase_flops():
    # a round is k_v personal steps and k_u shared steps (the mix is
    # elementwise, uncounted): F(k_u, k_v) = k_u u + k_v v.  At reduced()
    # width F(2, 1) + F(1, 2) = 3 F(1, 1) exactly, so k_u 2 doubles the
    # shared phase; at full width (the record) one more shared step, which
    # differentiates the whole body where a personal step reaches only
    # the head, adds more than the personal step and less than a round
    cfg = get_reduced("qwen2-0.5b")
    shape = dataclasses.replace(SHAPES_T["train_4k"], seq_len=32,
                                global_batch=4)
    lay = one_device_layout(2, 2)
    F = {kk: dryrun._flops(cfg, lay, shape, k_u=kk[0], k_v=kk[1])[0]
         for kk in ((1, 1), (2, 1), (1, 2))}
    assert F[2, 1] + F[1, 2] == 3 * F[1, 1]
    assert F[2, 1] - F[1, 1] > F[1, 2] - F[1, 1] > 0
    one = dryrun.run_one("h2o-danube-1.8b", "train_4k", "single", out=None)
    two = dryrun.run_one("h2o-danube-1.8b", "train_4k", "single", out=None,
                         k_u=2)
    u = two["flops"] - one["flops"]
    assert 0 < one["flops"] - u < u < one["flops"]
    assert "16 clients" in two["flops_how"]


def test_train_knobs_on_serve_shapes_are_noted():
    rec = _run(shape="prefill_32k", k_u=2, bf16_grads=True,
               gossip_dtype="bfloat16")
    plain = _run(shape="prefill_32k")
    assert rec["bytes_per_device"] == plain["bytes_per_device"]
    for k in ("k_u", "bf16_grads", "gossip_dtype"):
        assert "train step" in rec["knob_notes"][k]
    assert "k_v" not in rec["knob_notes"]


def test_every_knob_is_in_the_record():
    rec = _run(k_u=2, k_v=3, bf16_grads=True, kv_quant=True,
               bf16_params=True, moe_shard="data,model",
               gossip_dtype="bfloat16")
    assert {k: rec[k] for k in KNOBS} == dict(
        k_u=2, k_v=3, bf16_grads=True, gossip_dtype="bfloat16",
        kv_quant=True, bf16_params=True, moe_shard="data,model")
    plain = _run()
    assert {k: plain[k] for k in KNOBS} == dict(
        k_u=1, k_v=1, bf16_grads=False, gossip_dtype="", kv_quant=False,
        bf16_params=False, moe_shard="")
    # bf16 grads are temporaries cast after the model group's collectives
    assert "finish_grad" in rec["knob_notes"]["bf16_grads"]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-0.5b"])
def test_moe_shard_is_recorded_with_its_reason(arch):
    rec = _run(arch, "decode_32k", moe_shard="data,model")
    plain = _run(arch, "decode_32k")
    assert rec["moe_shard"] == "data,model"
    assert rec["bytes_per_device"] == plain["bytes_per_device"]
    note = rec["knob_notes"]["moe_shard"]
    assert "GSPMD" in note and "temporar" in note


def test_tag_names_the_file(tmp_path):
    out = tmp_path / "o"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                        "--resident", "--tag", "bf16", "--bf16-params",
                        "--no-flops", "--out", str(out)]) == 0
    (path,) = out.iterdir()
    assert path.name == "qwen2-0.5b__train_4k__single__matrix__resident" \
                        "__bf16.json"
    rec = json.loads(path.read_text())
    assert rec["tag"] == "bf16" and rec["bf16_params"] is True


@pytest.mark.parametrize("flags,word", [(["--keep-hlo"], "HLO"),
                                        (["--unroll"], "unroll"),
                                        (["--unroll", "--keep-hlo"], "HLO")])
def test_xla_flags_are_refused_before_any_combination(flags, word,
                                                      tmp_path, capsys):
    out = tmp_path / "o"
    rc = dryrun.main(["--all", "--no-flops", "--out", str(out)] + flags)
    err = capsys.readouterr()
    assert rc != 0 and word in err.err and "refused" in err.err
    assert not out.exists() and "[dryrun] qwen2" not in err.out


def test_reference_command_line_parses(tmp_path):
    # every flag of the reference's main, as it spells them (the ones the
    # port refuses aside)
    args = ["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh",
            "single", "--gossip", "ppermute", "--k_u", "2", "--k_v", "1",
            "--bf16-grads", "--bf16-params", "--moe-shard", "data,model",
            "--gossip-dtype", "bfloat16", "--resident", "--topology",
            "exponential", "--neighbors", "4", "--kv-quant", "--tag", "t"]
    assert dryrun.main(args + ["--no-flops", "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["gossip"] == "ppermute" and rec["resident"] is True
    assert rec["k_u"] == 2 and rec["tag"] == "t"
