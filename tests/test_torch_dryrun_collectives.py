"""The dry run's `collectives` (`launch/dryrun.py`, the counterpart of the
reference's `parse_collectives`): the model group's c10d collectives of
one call of the train step on rank 0, named and sized in the reference's
wire convention.  The count on meta tensors inside a single-process group
of T ranks (torch's `fake` backend) equals, op by op, the count of the
same step run for real on a two-rank gloo group (`python -m
repro_torch.launch.ranks_check`, job `collectives`) at a reduced dense
config and T = 2; the records say why where there is no count."""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import SHAPES, get_reduced
from repro_torch.launch import dryrun, steps
from test_torch_tp import finish_jobs, start_jobs

SEQ, BATCH = 16, 2
CASES = {
    "resident": dict(gossip="matrix", resident=True),
    "tree": dict(gossip="ppermute", resident=False),
    "knobs": dict(gossip="matrix", resident=True, k_u=2, k_v=3,
                  bf16_grads=True, gossip_dtype="bfloat16"),
}


def _cfg(arch="qwen2-0.5b"):
    # the ranks_check job's config: reduced(), compute in f32
    return get_reduced(arch).replace(compute_dtype="float32")


def _shape():
    return dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ)


def _meta_count(m, arch="qwen2-0.5b", **kw):
    return dryrun.count_on_meta(_cfg(arch), 2, m, _shape(),
                                per_client_batch=BATCH, **kw)


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    todo = {name: ("collectives", dict(arch="qwen2-0.5b", m=2, tp=2,
                                       seq=SEQ, batch=BATCH, **kw), {})
            for name, kw in CASES.items()}
    out = finish_jobs(start_jobs(tmp_path_factory, 2, todo))
    return {name: json.loads(str(res["counts"])) for name, res in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_meta_count_equals_a_real_two_rank_gloo_step(gloo_counts, case):
    real = gloo_counts[case]
    meta = _meta_count(2, **CASES[case])
    assert sorted(meta) == sorted(real)
    for op in real:
        assert meta[op] == real[op], op
    # qwen2's reduced model at T 2: the blocks' activations all-reduce
    assert real["all-reduce"]["count"] > 0
    if CASES[case]["resident"]:
        # the resident step gathers z and reduce-scatters the row gradient
        assert real["all-gather"]["count"] > 0
        assert real["reduce-scatter"]["count"] > 0


def test_wire_convention_of_each_op():
    # all-gather 1 x out, reduce-scatter 1 x in, as the reference sums its
    # HLO: each phase of a resident step gathers z row by row (the whole
    # f32 row out), and the u phase reduce-scatters each row's gradient
    # (the whole row in); m 2 clients, d the shared row's elements
    counts = _meta_count(2, gossip="matrix", resident=True)
    row = dryrun._row_bytes(steps.stacked_param_struct(_cfg(), 1), "")
    assert counts["all-gather"] == {"count": 4, "bytes": 4 * row}
    assert counts["reduce-scatter"] == {"count": 2, "bytes": 2 * row}


def test_bf16_grads_leave_the_collectives_and_bf16_params_halve_the_rows():
    plain = _meta_count(2, gossip="matrix", resident=True)
    assert _meta_count(2, gossip="matrix", resident=True,
                       bf16_grads=True) == plain
    cfg = _cfg().replace(param_dtype="bfloat16")
    half = dryrun.count_on_meta(cfg, 2, 2, _shape(), per_client_batch=BATCH,
                                gossip="matrix", resident=True)
    for op in ("all-gather", "reduce-scatter"):
        assert 2 * half[op]["bytes"] == plain[op]["bytes"]


@pytest.mark.parametrize("arch,shape,kw,word", [
    ("qwen2-0.5b", "train_4k", dict(resident=True), "n_heads=14"),
    ("qwen2-0.5b", "train_4k", {}, "--resident"),
    ("qwen2-0.5b", "prefill_32k", {}, "one device"),
    ("h2o-danube-1.8b", "decode_32k", {}, "one device"),
    ("deepseek-v2-236b", "train_4k", dict(resident=True), "FSDP"),
    ("deepseek-moe-16b", "train_4k", dict(resident=True), "routes"),
])
def test_null_with_the_reason(arch, shape, kw, word):
    rec = dryrun.run_one(arch, shape, "single", out=None, flops=False, **kw)
    assert rec["status"] == "ok" and rec["collectives"] is None
    assert word in rec["collectives_reason"]
    if word == "n_heads=14":
        assert "check_tp refuses the layout's model=16" in \
            rec["collectives_reason"]


@pytest.mark.parametrize("gossip,resident", [("matrix", True),
                                             ("ppermute", False)])
def test_full_width_record_counts_rank_zeros_model_group(gossip, resident):
    # h2o-danube-1.8b's 32 heads split over the production mesh's 16 model
    # ranks; each data index holds one of the 16 clients
    rec = dryrun.run_one("h2o-danube-1.8b", "train_4k", "single", out=None,
                         flops=False, gossip=gossip, resident=resident)
    c = rec["collectives"]
    assert "model=16" in rec["collectives_how"]
    assert "1 of 16 clients" in rec["collectives_how"]
    assert "`wire`" in rec["collectives_note"]
    assert c["all-reduce"]["count"] > 0 and c["all-reduce"]["bytes"] > 0
    assert ("reduce-scatter" in c) == resident
    assert set(c) <= {"all-reduce", "all-gather", "reduce-scatter"}


def test_counter_refuses_a_collective_it_cannot_name():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        group = dist.new_group([0, 1])
        x = torch.empty(4, device="meta")
        counter = dryrun.CollectiveCounter(group)
        with counter:
            dist.all_reduce(x)                   # the default group: passes
            dist.all_reduce(x, group=group)
            with pytest.raises(ValueError, match="broadcast"):
                dist.broadcast(x, 0, group=group)
        assert counter.counts == {"all-reduce": {"count": 1, "bytes": 32}}
        with pytest.raises(RuntimeError, match="process group of its own"):
            _meta_count(2, gossip="matrix", resident=True)
    finally:
        dist.destroy_process_group()
