"""Dry run of the production meshes: what every (architecture x input
shape x mesh) would place on each device, without a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh single [--gossip matrix|ppermute] \\
        [--resident] [--hbm-gb 80] [--out dryrun_out]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

For each applicable combination it builds the step (`steps.build_step`:
its meta-tensor structs and its `sharding.py` placements on the
production mesh description, `mesh.make_production_mesh`) and records:
- the layout;
- bytes per device of the step's arguments under their placements:
  params, the train state (momentum included), the batch, the decode
  cache; "fits" compares their sum with --hbm-gb (default 80, one H100
  80GB).  These count the arguments, not the temporaries a step makes;
- the wire bytes per device of one round's mix, from the row plans the
  cross-rank mixes execute (`ranks.permutation_steps` for ppermute,
  `ranks.gather_plan` of the schedule's round-0 table for the matrix
  mix), each client a rank and its row split over the TP axes;
- the step's FLOPs, counted by `torch.utils.flop_counter.FlopCounterMode`
  running it on the meta tensors; `"flops": null` with the reason where
  the step's shapes depend on its data (the moe dispatch keeps only the
  routed tokens).
One JSON a combination goes to --out (default `dryrun_out/`).  The
reference's dry run compiles for 512 forced host devices instead; the
port has no compiler to ask, so its numbers are the placements'
arithmetic and the counted operations.
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

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..core import partition, topology
from .. import models
from ..tree import get, paths, tree_map
from . import ranks, sharding, steps
from .mesh import make_production_mesh

NOTE = ("bytes per device count the step's arguments under their "
        "placements, not the temporaries the step makes")


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


def _wire(layout, d_row_bytes: int, gossip: str, schedule, tp: int) -> dict:
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
            "row_bytes_per_device": d_row_bytes // tp,
            "bytes_per_device": max(sent, got) * (d_row_bytes // tp)}


def _count(cfg, layout, shape) -> int:
    """FlopCounterMode's total over one call of `shape`'s step for the
    layout's clients, run on the meta structs."""
    from torch.utils.flop_counter import FlopCounterMode
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fn, _, _, args, _ = steps.build_step(cfg, None, layout, shape)
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


def _flops(cfg, layout, shape) -> tuple:
    """(FLOPs, how, None) of one step, or (None, None, reason).

    `FlopCounterMode` counts matmul-like operations (mm, bmm, attention)
    on the meta tensors of ONE client's step, times the layout's clients:
    the clients are independent and alike (the train step vmaps them, the
    serve steps loop them), and the mix is elementwise, which the counter
    does not count.  Prefill runs the training route's forward without
    autograd (the kernel route's plain versions loop over positions on
    the host; the operations are the same)."""
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
            shape, seq_len=k * chunk)) for k in (1, 2))
        n = shape.seq_len // chunk
        total = one_c + (n - 1) * (two_c - one_c)
        how += (f", counted at S {chunk} and {2 * chunk} and extended "
                f"to {n} chunks (affine in the chunks)")
    else:
        total = _count(cfg, one, shape)
        if shape.kind == "prefill":
            how += " (the training route's forward, no autograd)"
    return total * layout.n_clients, how, None


def run_one(arch: str, shape_name: str, mesh_kind: str,
            gossip: str = "matrix", resident: bool = False,
            topology_kind: str = "random", n_neighbors: int = 10,
            hbm_gb: float = 80.0, out: str | None = "dryrun_out",
            flops: bool = True) -> dict:
    """The record of one combination (written to `out` unless None)."""
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not shape_applicable(arch, shape_name):
        return dict(rec, status="skipped",
                    reason="full-attention arch; long_500k needs "
                           "sub-quadratic attention")
    t0 = time.perf_counter()
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    layout = steps.decide_layout(mesh, arch, shape)
    kw = {}
    schedule = None
    if shape.kind == "train":
        kind = "exponential" if gossip == "ppermute" else topology_kind
        schedule = topology.get_schedule(
            kind, layout.n_clients, n_neighbors if kind == "random" else 0, 0)
        kw = dict(schedule=schedule, resident=resident)
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
    rec.update(
        status="ok", gossip=gossip if shape.kind == "train" else None,
        resident=bool(resident) if shape.kind == "train" else None,
        layout={"client_axes": layout.client_axes,
                "batch_axes": layout.batch_axes, "tp_axes": layout.tp_axes,
                "fsdp_axes": layout.fsdp_axes,
                "n_clients": layout.n_clients,
                "per_client_batch": layout.per_client_batch},
        n_devices=sharding.shards(tuple(mesh.axis_names), mesh),
        bytes_per_device=per_device, bytes_per_device_total=total,
        hbm_gb=hbm_gb, fits=total <= hbm_gb * 1e9, bytes_note=NOTE)
    if shape.kind == "train":
        template = tree_map(lambda x: x[0], params_struct)
        mask = partition.build_mask(template, partition.classifier_personal)
        row = sum(leaf.numel() * leaf.element_size()
                  for p, leaf in paths(template) if get(mask, p))
        rec["wire"] = _wire(layout, row, gossip, schedule,
                            sharding.axes_size(mesh, layout.tp_axes))
    if flops:
        rec["flops"], how, reason = _flops(cfg, layout, shape)
        rec["flops_how" if how else "flops_reason"] = how or reason
    rec["seconds"] = time.perf_counter() - t0
    if out is not None:
        path = Path(out)
        path.mkdir(parents=True, exist_ok=True)
        sfx = ("__resident" if resident and shape.kind == "train" else "")
        name = f"{arch}__{shape_name}__{mesh_kind}__{gossip}{sfx}.json"
        (path / name).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--gossip", default="matrix",
                    choices=["matrix", "ppermute"])
    ap.add_argument("--resident", action="store_true",
                    help="the resident flat-buffer train step")
    ap.add_argument("--topology", default="random", dest="topology_kind",
                    choices=["random", "exponential", "ring", "full"],
                    help="the matrix mix's schedule (ppermute: the one-peer "
                         "exponential graph)")
    ap.add_argument("--neighbors", type=int, default=10,
                    help="in-degree of --topology random (paper: 10)")
    ap.add_argument("--hbm-gb", type=float, default=80.0)
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--no-flops", dest="flops", action="store_false",
                    help="skip the FLOP count (the slowest part)")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on this mesh")
    args = ap.parse_args(argv)
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    failed = 0
    for arch, shp in combos:
        try:
            rec = run_one(arch, shp, args.mesh, gossip=args.gossip,
                          resident=args.resident,
                          topology_kind=args.topology_kind,
                          n_neighbors=args.neighbors, hbm_gb=args.hbm_gb,
                          out=args.out, flops=args.flops)
        except Exception as e:      # report every combination, then fail
            failed += 1
            print(f"[dryrun] {arch:22s} {shp:12s} {args.mesh:6s} FAILED: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        extra = ""
        if rec["status"] == "ok":
            f = rec.get("flops")
            extra = (f" bytes/device={rec['bytes_per_device_total']:.3e} "
                     f"fits={rec['fits']} flops="
                     + (f"{f:.3e}" if f is not None else "null")
                     + f" {rec['seconds']:.1f}s")
        print(f"[dryrun] {arch:22s} {shp:12s} {args.mesh:6s} "
              f"{rec['status']}{extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
