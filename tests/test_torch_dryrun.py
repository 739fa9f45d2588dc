"""The dry run of the production meshes (`python -m
repro_torch.launch.dryrun`): every applicable (arch x shape) on the
single-pod and the multi-pod mesh exits 0 on the CPU, one JSON per
combination under --out and nothing elsewhere; each record's param
bytes per device equal the reference's arithmetic (its dry run's) on
`jax.eval_shape` structs under its own specs; the FLOPs come from
`FlopCounterMode` on the meta structs (null, with the reason, for the
moe dispatch), xlstm's extended from one and two whole chunks exactly.
The `--all` runs skip the FLOP count (`--no-flops`, the slow part:
xlstm's sLSTM steps on meta tensors); single combinations count it."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable
from repro.launch import steps as jsteps
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun, mesh

SRC = str(Path(__file__).resolve().parent.parent / "src")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _cli(argv, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun"]
                          + argv, cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module", params=["single", "multi"])
def all_records(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    res = _cli(["--all", "--mesh", request.param, "--no-flops", "--out",
                str(tmp / "out")], tmp)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return request.param, tmp, res.stdout


def _reference_param_bytes(arch, shape_name, kind) -> int:
    """The reference dry run's arithmetic on its own specs and structs."""
    sizes = MESHES[kind]
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    lay = jsteps.decide_layout(mesh, arch, SHAPES[shape_name])
    struct = jsteps.stacked_param_struct(jget_config(arch), lay.n_clients)
    specs = jsteps.params_shardings(struct, mesh, lay)
    pb = 0
    for leaf, sh in zip(jax.tree.leaves(struct), jax.tree.leaves(specs)):
        n = 1
        for ax in jax.tree.leaves(tuple(sh.spec)):
            if ax is not None:
                n *= mesh.shape[ax]
        pb += leaf.size * leaf.dtype.itemsize // n
    return pb


def test_all_writes_one_record_per_applicable_combination(all_records):
    kind, tmp, stdout = all_records
    want = {f"{a}__{s}__{kind}__matrix.json" for a in ARCH_IDS
            for s in SHAPES if shape_applicable(a, s)}
    assert set(os.listdir(tmp / "out")) == want
    # nothing written anywhere else
    assert set(os.listdir(tmp)) == {"out"}
    assert stdout.count(" ok ") == len(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_bytes_match_reference_arithmetic(all_records, arch):
    kind, tmp, _ = all_records
    for shape_name in SHAPES:
        if not shape_applicable(arch, shape_name):
            continue
        rec = json.loads((tmp / "out" / f"{arch}__{shape_name}__{kind}"
                          "__matrix.json").read_text())
        assert rec["status"] == "ok"
        assert rec["bytes_per_device"]["params"] == \
            _reference_param_bytes(arch, shape_name, kind), shape_name
        assert rec["layout"]["n_clients"] * \
            rec["layout"]["per_client_batch"] == \
            SHAPES[shape_name].global_batch
        assert rec["fits"] == (rec["bytes_per_device_total"]
                               <= rec["hbm_gb"] * 1e9)
        assert "temporaries" in rec["bytes_note"]


@pytest.mark.parametrize("gossip,received", [("matrix", None),
                                             ("ppermute", 1)])
def test_wire_bytes_follow_the_mix_plans(gossip, received):
    rec = dryrun.run_one("qwen2-0.5b", "train_4k", "single", gossip=gossip,
                         out=None, flops=False)
    wire = rec["wire"]
    # qwen2-0.5b's shared row, 494,031,872 f32 a client, split over the
    # 16 model devices
    assert wire["row_bytes_per_device"] == 494_031_872 * 4 // 16
    if received is not None:
        assert wire["rows_received"] == wire["rows_sent"] == received
    else:
        # the paper's 10 random in-neighbors of 16 clients: rank 0 reads
        # its 10 neighbors (self excluded) from other ranks
        assert 1 <= wire["rows_received"] <= 10
    assert wire["bytes_per_device"] == \
        max(wire["rows_sent"], wire["rows_received"]) * \
        wire["row_bytes_per_device"]


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_flops_counted_on_meta(shape_name, tmp_path):
    res = _cli(["--arch", "qwen2-0.5b", "--shape", shape_name, "--out",
                str(tmp_path / "o")], tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads(next((tmp_path / "o").iterdir()).read_text())
    assert rec["flops"] > 0 and "16 clients" in rec["flops_how"]
    if shape_name == "prefill_32k":
        # at least lm_head's and the projections' 2 * N * params, the
        # attention's quadratic part on top
        assert rec["flops"] > 2 * 32 * 32_768 * 360e6


def test_moe_flops_are_null_with_the_reason():
    rec = dryrun.run_one("deepseek-moe-16b", "decode_32k", "single",
                         out=None)
    assert rec["flops"] is None and "routes" in rec["flops_reason"]


def test_skipped_combination_writes_nothing(tmp_path):
    rec = dryrun.run_one("qwen2-0.5b", "long_500k", "single",
                         out=str(tmp_path / "o"))
    assert rec["status"] == "skipped" and not (tmp_path / "o").exists()


def test_ssm_flops_extension_equals_the_full_count():
    # xlstm's count at 1 and 2 whole chunks extended to 4 equals the count
    # at 4 chunks (reduced(): chunk 16, S 64; 2 clients)
    cfg = get_reduced("xlstm-125m")
    shape = dataclasses.replace(TSHAPES["train_4k"],
                                seq_len=4 * cfg.mlstm_chunk, global_batch=4)
    layout = mesh.one_device_layout(2, 2)
    got, how, _ = dryrun._flops(cfg, layout, shape)
    assert "extended to 4 chunks" in how
    assert got == 2 * dryrun._count(cfg, layout._replace(n_clients=1), shape)
