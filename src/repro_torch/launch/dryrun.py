"""Dry run of the production meshes: what every (architecture x input
shape x mesh) would place on each device, without a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single [--gossip matrix|ppermute] \\
        [--resident] [--k_u 1] [--k_v 1] [--bf16-grads] [--bf16-params] \\
        [--kv-quant] [--moe-shard expert,data] [--gossip-dtype bfloat16] \\
        [--tag NAME] [--hbm-gb 80] [--out dryrun_out]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

For each applicable combination it builds the step (`steps.build_step`:
its meta-tensor structs and its `sharding.py` placements on the
production mesh description, `mesh.make_production_mesh`) and records:
- the layout and the knobs it was built with;
- bytes per device of the step's arguments under their placements:
  params, the train state (momentum included), the batch, the decode
  cache; "fits" compares their sum with --hbm-gb (default 80, one H100
  80GB).  These count the arguments, not the temporaries a step makes;
- the wire bytes per device of one round's mix, from the row plans the
  cross-rank mixes execute (`ranks.permutation_steps` for ppermute,
  `ranks.gather_plan` of the schedule's round-0 table for the matrix
  mix), each client a rank and its row split over the TP axes, a row's
  elements at the --gossip-dtype width (default the parameters');
- `collectives`: {op: {"count", "bytes"}} of the model group's
  collectives on rank 0 for one call of the step (`count_collectives`),
  named and sized as the reference's dry run sums its HLO (all-reduce 2
  x out, all-gather 1 x out, reduce-scatter 1 x in); `"collectives":
  null` with `collectives_reason` where the port has no such step across
  ranks or the count cannot be had;
- the step's FLOPs, counted by `torch.utils.flop_counter.FlopCounterMode`
  running it, with the same knobs, on the meta tensors; `"flops": null`
  with the reason where the step's shapes depend on its data (the moe
  dispatch keeps only the routed tokens).
A knob that changes no number the port counts is named in `knob_notes`
with the reason.  One JSON a combination goes to --out (default
`dryrun_out/`), named arch__shape__mesh__gossip[__resident][__tag].json.
The reference's dry run compiles for 512 forced host devices instead; the
port has no compiler to ask, so its numbers are the placements'
arithmetic and the counted operations.  Its --keep-hlo and --unroll are
XLA's (the HLO text; unrolled layer scans for its cost analysis): the
port compiles no HLO and its forwards loop over layers in Python, so
both flags are refused, before any combination runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import warnings
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..core import partition, topology
from .. import models
from ..tree import get, paths, tree_map
from . import ranks, sharding, steps, tp
from .mesh import make_host_mesh, make_production_mesh, one_device_layout

NOTE = ("bytes per device count the step's arguments under their "
        "placements, not the temporaries the step makes")
COLLECTIVES_NOTE = (
    "the model group's collectives on rank 0 (one data index) for one call "
    "of the step; the mix's rows cross the data group point to point (in "
    "`wire`) and the data group's gathers of mu and its metric reductions "
    "are not counted")
TRAIN_KNOBS = {"k_u": 1, "k_v": 1, "bf16_grads": False, "gossip_dtype": ""}
# why a knob changes no number the port counts
KNOB_NOTES = {
    "train_only": "a train step's knob: the prefill and decode steps take "
                  "none (as in the reference)",
    "bf16_grads": "casts the shared gradients, temporaries of the step, "
                  "after the model group's collectives (`Executor."
                  "finish_grad` reduces the f32 row gradient); the FLOP "
                  "counter counts no casts",
    "gossip_dtype": "one client: no mix to narrow",
    "kv_quant": "only the dense family's decode cache reads kv_quant",
    "moe_shard": "pins the reference's moe dispatch buffer, a temporary, "
                 "to mesh axes under GSPMD; the port counts arguments, "
                 "not temporaries, and places nothing by GSPMD",
}

# the c10d ops the port's steps issue, under the reference dry run's
# names and wire bytes: c10d op -> (name, the argument whose tensors are
# sized, times); all-reduce 2 x out (ring reduce-scatter + all-gather),
# all-gather 1 x out, reduce-scatter 1 x in
C10D_OPS = {
    "allreduce_": ("all-reduce", "tensors", 2),
    "allgather_": ("all-gather", "output_tensors", 1),
    "_allgather_base_": ("all-gather", "output_tensor", 1),
    "_reduce_scatter_base_": ("reduce-scatter", "input_tensor", 1),
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_tensor_bytes(a) for a in x)


class CollectiveCounter(TorchDispatchMode):
    """While active, counts the c10d collectives issued on `group`:
    `.counts` is {op: {"count", "bytes"}} under `C10D_OPS`' names and wire
    convention.  A c10d op on that group it cannot name raises (a count
    missing it would be wrong); ops on other groups pass uncounted."""

    def __init__(self, group):
        super().__init__()
        self.group_name = group.group_name
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            names = [a.name for a in func._schema.arguments]
            if "process_group" in names:
                import torch.distributed as dist
                pg = dist.ProcessGroup.unbox(
                    args[names.index("process_group")])
                if pg.group_name == self.group_name:
                    self._count(func, names, args)
        return func(*args, **(kwargs or {}))

    def _count(self, func, names, args) -> None:
        op = func._opname
        if op not in C10D_OPS:
            raise ValueError(f"c10d.{op} on the counted group: not a "
                             f"collective the count names ({sorted(C10D_OPS)})")
        name, arg, times = C10D_OPS[op]
        rec = self.counts.setdefault(name, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += times * _tensor_bytes(args[names.index(arg)])


def _bytes(x, spec, mesh) -> int:
    """Bytes per device of a struct (meta tensors in dicts, lists and
    NamedTuples) under its parallel placement tree."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size() // sharding.shards(spec, mesh)
    if isinstance(x, dict):
        return sum(_bytes(x[k], spec[k], mesh) for k in x)
    if isinstance(x, (list, tuple)):
        return sum(_bytes(a, spec[i], mesh) for i, a in enumerate(x))
    return 0


def _wire(layout, d_row_bytes: int, gossip: str, schedule, tp_size: int
          ) -> dict:
    """One round's mix on rank 0 of the client axes, each client a rank:
    the rows it sends and receives and their bytes per device (a row is
    split over the TP axes)."""
    m = layout.n_clients
    if m < 2:
        return {"gossip": gossip, "rows_sent": 0, "rows_received": 0,
                "bytes_per_device": 0, "note": "one client: no mix"}
    if gossip == "ppermute":
        off = schedule.permutation_offsets()[0]
        plan = ranks.permutation_steps(m, m, 0, off)
        sent = sum(len(st.sends) for st in plan)
        got = sum(st.local is None for st in plan)
    else:
        plan = ranks.gather_plan(schedule.at(0).idx.tolist(), m, m, 0)
        sent = sum(len(rows) for _, rows in plan.send)
        got = len(plan.halo)
    return {"gossip": gossip, "topology": schedule.kind,
            "rows_sent": sent, "rows_received": got,
            "row_bytes_per_device": d_row_bytes // tp_size,
            "bytes_per_device": max(sent, got) * (d_row_bytes // tp_size)}


def _row_bytes(params_struct, gossip_dtype: str) -> int:
    """Bytes of one client's shared row on the wire: its elements at the
    gossip dtype's width (default each leaf's own)."""
    template = tree_map(lambda x: x[0], params_struct)
    mask = partition.build_mask(template, partition.classifier_personal)
    width = getattr(torch, gossip_dtype).itemsize if gossip_dtype else None
    return sum(leaf.numel() * (width or leaf.element_size())
               for p, leaf in paths(template) if get(mask, p))


def _count(cfg, layout, shape, **knobs) -> int:
    """FlopCounterMode's total over one call of `shape`'s step for the
    layout's clients, built with the train `knobs`, run on the meta
    structs."""
    from torch.utils.flop_counter import FlopCounterMode
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fn, _, _, args, _ = steps.build_step(cfg, None, layout, shape,
                                             **knobs)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            fn(*args)
        elif shape.kind == "prefill":
            batch = tree_map(lambda x: x[0], args[1])
            inputs = batch if cfg.family in ("vlm", "encdec") \
                else batch["tokens"]
            forward = getattr(models, cfg.family).forward_train
            with torch.no_grad():
                forward(tree_map(lambda x: x[0], args[0]), inputs, cfg,
                        last_only=True, route="plain")
        else:
            # decode steps read the position on the host
            with torch.no_grad():
                fn(*args[:3], shape.seq_len - 1)
    return int(fc.get_total_flops())


def _flops(cfg, layout, shape, **knobs) -> tuple:
    """(FLOPs, how, None) of one step, or (None, None, reason).

    `FlopCounterMode` counts matmul-like operations (mm, bmm, attention)
    on the meta tensors of ONE client's step, times the layout's clients:
    the clients are independent and alike (the train step vmaps them, the
    serve steps loop them), and the mix is elementwise, which the counter
    does not count.  Prefill runs the training route's forward without
    autograd (the kernel route's plain versions loop over positions on
    the host; the operations are the same).  `knobs`: the train step's
    (k_u, k_v, bf16_grads, gossip_dtype)."""
    if cfg.family == "moe":
        return None, None, ("the moe dispatch's shapes depend on the routes "
                            "(data): no meta-tensor count")
    one = layout._replace(n_clients=1)
    how = f"one client's step counted, times {layout.n_clients} clients"
    chunk = cfg.mlstm_chunk
    if cfg.family == "ssm" and shape.kind != "decode" and \
            shape.seq_len > 2 * chunk:
        # the sLSTM is a host loop over S, minutes on meta tensors at S
        # 4,096: count 1 and 2 whole chunks and extend, the step being
        # affine in the number of chunks (projections, the mLSTM's
        # chunks after the first, the sLSTM steps and lm_head each add
        # the same per chunk)
        one_c, two_c = (_count(cfg, one, dataclasses.replace(
            shape, seq_len=k * chunk), **knobs) for k in (1, 2))
        n = shape.seq_len // chunk
        total = one_c + (n - 1) * (two_c - one_c)
        how += (f", counted at S {chunk} and {2 * chunk} and extended "
                f"to {n} chunks (affine in the chunks)")
    else:
        total = _count(cfg, one, shape, **knobs)
        if shape.kind == "prefill":
            how += " (the training route's forward, no autograd)"
    return total * layout.n_clients, how, None


def _rank_state(algo, state, resident: bool):
    """A state of whole rows and leaves -> the rank's (its columns of the
    buffer, its shards of every leaf)."""
    ex = algo.tp
    if resident:
        return ex.shard_state(state)
    return state._replace(
        params=ex.shard(state.params),
        opt_u=state.opt_u._replace(momentum=ex.shard(state.opt_u.momentum)),
        opt_v=state.opt_v._replace(momentum=ex.shard(state.opt_v.momentum)))


def _real_params(cfg, m: int, device, seed: int) -> dict:
    """m clients' params from the family's init, a generator seeded
    `seed` on `device`."""
    api = models.get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda *a: torch.stack(a), *[
        api.init_params(gen, cfg, device=device) for _ in range(m)])


def _real_batches(struct, cfg, device, seed: int) -> dict:
    """Tensors of `struct`'s shapes: token ids below the vocabulary, the
    float inputs (a vlm's vision embeddings, an encdec's frames) normal."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(x):
        if x.dtype == torch.int64:
            return torch.randint(0, cfg.vocab, tuple(x.shape), generator=gen,
                                 device=device)
        return torch.randn(tuple(x.shape), generator=gen, device=device,
                           dtype=x.dtype)
    return tree_map(one, struct)


def count_collectives(cfg, mesh, shape, *, per_client_batch: int,
                      gossip: str = "matrix", resident: bool = False,
                      k_u: int = 1, k_v: int = 1, bf16_grads: bool = False,
                      gossip_dtype: str = "", device="meta") -> dict:
    """{op: {"count", "bytes"}} of the collectives one call of the train
    step issues on this rank's model group (`CollectiveCounter`): the
    rank's share (`steps.build_train_algo` on the client mesh `mesh`, its
    `mesh.n_clients` clients at `per_client_batch`) of one resident
    (`round_fn_flat`) or tree-form (`round_fn`) round.  device "meta"
    runs it on meta tensors (no data, no memory); another device runs it
    on the family's init and random batches (generators seeded 0, 1).  The
    matrix mix reads the "full" table of the mesh's clients, whose rows
    the data group exchanges point to point: the model group's
    collectives do not depend on it."""
    dev = torch.device(device)
    m = mesh.n_clients
    layout = one_device_layout(m, per_client_batch)
    table = topology.get_schedule("full", m, 0, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        algo, _, params_struct, flat_layout = steps.build_train_algo(
            cfg, mesh, layout, k_u=k_u, k_v=k_v, gossip=gossip,
            bf16_grads=bf16_grads, gossip_dtype=gossip_dtype,
            schedule=table if gossip == "matrix" else None,
            resident=resident)
    batches = steps.input_specs(cfg, shape, layout, k_u=k_u,
                                k_v=k_v)["batches"]
    params = params_struct
    if dev.type != "meta":
        params = _real_params(cfg, m, dev, 0)
        batches = _real_batches(batches, cfg, dev, 1)
    if resident:
        state = algo.init_flat(params, flat_layout, device=dev)[0]
    else:
        state = algo.init(params, device=dev)
    state = _rank_state(algo, state, resident)
    P = table.at(0)
    counter = CollectiveCounter(mesh.model_group)
    with counter:
        if resident:
            algo.round_fn_flat(state, P, batches, flat_layout)
        else:
            algo.round_fn(state, P, batches)
    return counter.counts


def _no_collectives(cfg, layout, shape, gossip: str, resident: bool,
                    T: int):
    """Why the port has no count of this combination's collectives, or
    None."""
    if shape.kind != "train":
        return ("the port's prefill and decode steps run each client's "
                "whole model on one device (`steps.build_prefill_step`, "
                "`build_decode_step`): no step across ranks to count")
    if layout.fsdp_axes:
        return (f"the layout is FSDP over {layout.fsdp_axes}, which the "
                f"port does not execute across ranks")
    if cfg.family == "moe":
        return ("the moe dispatch's shapes depend on the routes (data): no "
                "meta-tensor count")
    if gossip == "matrix" and not resident:
        return ("the port's matrix mix across ranks runs on the resident "
                "buffer (--resident); the tree-form round across ranks "
                "mixes with --gossip ppermute")
    try:
        tp.check_tp(cfg, T)
    except ValueError as e:
        return f"tp.check_tp refuses the layout's model={T}: {e}"
    return None


def count_on_meta(cfg, T: int, n_local: int, shape, *,
                  per_client_batch: int, **kw) -> dict:
    """`count_collectives` of rank 0 of T model ranks holding `n_local`
    clients, on meta tensors inside a single-process group of T ranks
    (torch's `fake` backend, which communicates nothing).  Joins and
    leaves that group itself, so no process group may be initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the collectives count joins a process group of "
                           "its own: run it where none is initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=T)
    try:
        return count_collectives(cfg, make_host_mesh(n_local, model=T),
                                 shape, per_client_batch=per_client_batch,
                                 device="meta", **kw)
    finally:
        dist.destroy_process_group()


def _collectives(cfg, layout, shape, mesh, *, gossip: str,
                 resident: bool, **knobs) -> tuple:
    """(counts, how, None), or (None, None, reason): rank 0's share of
    the step (one data index, m / D clients) counted by `count_on_meta`
    at the layout's T model ranks."""
    T = sharding.axes_size(mesh, layout.tp_axes)
    reason = _no_collectives(cfg, layout, shape, gossip, resident, T)
    if reason:
        return None, None, reason
    n_local = layout.n_clients // sharding.axes_size(mesh,
                                                     layout.client_axes)
    try:
        counts = count_on_meta(cfg, T, n_local, shape,
                               per_client_batch=layout.per_client_batch,
                               gossip=gossip, resident=resident, **knobs)
    except ImportError as e:
        return None, None, f"this torch has no fake process group: {e}"
    how = (f"rank 0 of model={T}, its {n_local} of {layout.n_clients} "
           f"clients, counted on meta tensors in a one-process group of "
           f"{T} ranks (no communication)")
    return counts, how, None


def _knob_notes(cfg, layout, shape, knobs: dict) -> dict:
    """{knob: why it changes no number the port counts} of the knobs set."""
    notes = {}
    train = shape.kind == "train"
    for k, default in TRAIN_KNOBS.items():
        if not train and knobs[k] != default:
            notes[k] = KNOB_NOTES["train_only"]
    if train and knobs["bf16_grads"]:
        notes["bf16_grads"] = KNOB_NOTES["bf16_grads"]
    if train and knobs["gossip_dtype"] and layout.n_clients < 2:
        notes["gossip_dtype"] = KNOB_NOTES["gossip_dtype"]
    if knobs["kv_quant"] and (shape.kind != "decode"
                              or cfg.family != "dense"):
        notes["kv_quant"] = KNOB_NOTES["kv_quant"]
    if knobs["moe_shard"]:
        notes["moe_shard"] = KNOB_NOTES["moe_shard"]
    return notes


def run_one(arch: str, shape_name: str, mesh_kind: str,
            gossip: str = "matrix", resident: bool = False,
            topology_kind: str = "random", n_neighbors: int = 10,
            k_u: int = 1, k_v: int = 1, bf16_grads: bool = False,
            kv_quant: bool = False, bf16_params: bool = False,
            moe_shard: str = "", gossip_dtype: str = "", tag: str = "",
            hbm_gb: float = 80.0, out: str | None = "dryrun_out",
            flops: bool = True) -> dict:
    """The record of one combination (written to `out` unless None).
    The knobs are the reference's: bf16_params, kv_quant and moe_shard
    change the config (param_dtype bfloat16, the int8 decode cache, the
    dispatch's mesh axes); k_u, k_v, bf16_grads and gossip_dtype reach a
    train step; tag suffixes the file name."""
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not shape_applicable(arch, shape_name):
        return dict(rec, status="skipped",
                    reason="full-attention arch; long_500k needs "
                           "sub-quadratic attention")
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
    if bf16_params:
        cfg = cfg.replace(param_dtype="bfloat16")
    if moe_shard:
        cfg = cfg.replace(moe_dispatch_axes=tuple(moe_shard.split(",")))
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    layout = steps.decide_layout(mesh, arch, shape)
    knobs = dict(k_u=k_u, k_v=k_v, bf16_grads=bf16_grads,
                 gossip_dtype=gossip_dtype)
    train_knobs = knobs if shape.kind == "train" else {}
    kw = {}
    schedule = None
    if shape.kind == "train":
        kind = "exponential" if gossip == "ppermute" else topology_kind
        schedule = topology.get_schedule(
            kind, layout.n_clients, n_neighbors if kind == "random" else 0, 0)
        kw = dict(schedule=schedule, resident=resident, **knobs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fn, ins, outs, args, _ = steps.build_step(cfg, mesh, layout, shape,
                                                  **kw)
    params_struct = steps.stacked_param_struct(cfg, layout.n_clients)
    params_spec = steps.params_shardings(params_struct, mesh, layout)
    per_device = {"params": _bytes(params_struct, params_spec, mesh)}
    if shape.kind == "train":
        per_device["state"] = _bytes(args[0], ins[0], mesh)
        per_device["topology"] = _bytes(args[1], ins[1], mesh)
        per_device["batch"] = _bytes(args[2], ins[2], mesh)
    elif shape.kind == "prefill":
        per_device["batch"] = _bytes(args[1], ins[1], mesh)
    else:
        per_device["cache"] = _bytes(args[1], ins[1], mesh)
        per_device["batch"] = _bytes(args[2], ins[2], mesh)
    total = sum(v for k, v in per_device.items()
                if not (k == "params" and "state" in per_device))
    all_knobs = dict(knobs, kv_quant=bool(kv_quant),
                     bf16_params=bool(bf16_params), moe_shard=moe_shard)
    rec.update(
        status="ok", gossip=gossip if shape.kind == "train" else None,
        resident=bool(resident) if shape.kind == "train" else None,
        layout={"client_axes": layout.client_axes,
                "batch_axes": layout.batch_axes, "tp_axes": layout.tp_axes,
                "fsdp_axes": layout.fsdp_axes,
                "n_clients": layout.n_clients,
                "per_client_batch": layout.per_client_batch},
        **all_knobs, tag=tag,
        n_devices=sharding.shards(tuple(mesh.axis_names), mesh),
        bytes_per_device=per_device, bytes_per_device_total=total,
        hbm_gb=hbm_gb, fits=total <= hbm_gb * 1e9, bytes_note=NOTE)
    rec["knob_notes"] = _knob_notes(cfg, layout, shape, all_knobs)
    tp_size = sharding.axes_size(mesh, layout.tp_axes)
    if shape.kind == "train":
        rec["wire"] = _wire(layout, _row_bytes(params_struct, gossip_dtype),
                            gossip, schedule, tp_size)
    rec["collectives"], how, reason = _collectives(
        cfg, layout, shape, mesh, gossip=gossip, resident=resident,
        **knobs)
    if how:
        rec.update(collectives_how=how, collectives_note=COLLECTIVES_NOTE)
    else:
        rec["collectives_reason"] = reason
    if flops:
        rec["flops"], how, reason = _flops(cfg, layout, shape, **train_knobs)
        rec["flops_how" if how else "flops_reason"] = how or reason
    rec["seconds"] = time.perf_counter() - t0
    if out is not None:
        path = Path(out)
        path.mkdir(parents=True, exist_ok=True)
        sfx = ("__resident" if resident and shape.kind == "train" else "") \
            + (f"__{tag}" if tag else "")
        name = f"{arch}__{shape_name}__{mesh_kind}__{gossip}{sfx}.json"
        (path / name).write_text(json.dumps(rec, indent=1))
    return rec


def _collective_bytes(rec: dict):
    c = rec.get("collectives")
    return None if c is None else sum(v["bytes"] for v in c.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--gossip", default="matrix",
                    choices=["matrix", "ppermute"])
    ap.add_argument("--k_u", type=int, default=1)
    ap.add_argument("--k_v", type=int, default=1)
    ap.add_argument("--keep-hlo", action="store_true",
                    help="refused: the port compiles no HLO")
    ap.add_argument("--unroll", action="store_true",
                    help="refused: the port's forwards loop over layers in "
                         "Python, with no scan to unroll")
    ap.add_argument("--bf16-grads", action="store_true")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--moe-shard", default="",
                    help="expert,token mesh axes for the dispatch buffer")
    ap.add_argument("--gossip-dtype", default="",
                    help="bfloat16 = quantized push-sum payload")
    ap.add_argument("--resident", action="store_true",
                    help="the resident flat-buffer train step")
    ap.add_argument("--topology", default="random", dest="topology_kind",
                    choices=["random", "exponential", "ring", "full"],
                    help="the matrix mix's schedule (ppermute: the one-peer "
                         "exponential graph)")
    ap.add_argument("--neighbors", type=int, default=10,
                    help="in-degree of --topology random (paper: 10)")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--tag", default="", help="record file-name suffix")
    ap.add_argument("--hbm-gb", type=float, default=80.0)
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--no-flops", dest="flops", action="store_false",
                    help="skip the FLOP count (the slowest part)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on this mesh")
    args = ap.parse_args(argv)
    refused = [(flag, why) for flag, on, why in (
        ("--keep-hlo", args.keep_hlo, "the port compiles no HLO to keep"),
        ("--unroll", args.unroll, "the port's forwards loop over layers "
                                  "in Python: there is no scan to unroll"))
        if on]
    if refused:
        for flag, why in refused:
            print(f"[dryrun] {flag} is XLA's and refused: {why}",
                  file=sys.stderr)
        return 2
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    failed = 0
    for arch, shp in combos:
        try:
            rec = run_one(arch, shp, args.mesh, gossip=args.gossip,
                          resident=args.resident,
                          topology_kind=args.topology_kind,
                          n_neighbors=args.neighbors, k_u=args.k_u,
                          k_v=args.k_v, bf16_grads=args.bf16_grads,
                          kv_quant=args.kv_quant,
                          bf16_params=args.bf16_params,
                          moe_shard=args.moe_shard,
                          gossip_dtype=args.gossip_dtype, tag=args.tag,
                          hbm_gb=args.hbm_gb, out=args.out, flops=args.flops)
        except Exception as e:      # report every combination, then fail
            failed += 1
            print(f"[dryrun] {arch:22s} {shp:12s} {args.mesh:6s} FAILED: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        extra = ""
        if rec["status"] == "ok":
            f, c = rec.get("flops"), _collective_bytes(rec)
            extra = (f" bytes/device={rec['bytes_per_device_total']:.3e} "
                     f"fits={rec['fits']} flops="
                     + (f"{f:.3e}" if f is not None else "null")
                     + " colls=" + (f"{c:.3e}B" if c is not None else "null")
                     + f" {rec['seconds']:.1f}s")
        print(f"[dryrun] {arch:22s} {shp:12s} {args.mesh:6s} "
              f"{rec['status']}{extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
