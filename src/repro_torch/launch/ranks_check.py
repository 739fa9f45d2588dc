"""Cross-rank mixes and rounds on arrays from files, over W spawned ranks.

    python -m repro_torch.launch.ranks_check --world W [--device cuda|cpu] \\
        --job JOB IN.npz OUT.npz [--job JOB IN.npz OUT.npz ...]

The ranks run on the card (NCCL) unless `--device cpu` asks for gloo.

Every rank joins one process group (`ranks.init`, a file rendezvous in a
fresh temporary directory) and runs the jobs in turn on the client mesh
(data W / T, model T), T = meta.tp (default 1): each rank takes its data
index's block of the client rows and its model index's shards of them
(`launch/tp.py`), and rank 0 writes the whole leaves and rows gathered
back in order.  IN.npz holds the arrays and, under "meta", a JSON object
of the job's settings; meta.cfg replaces fields of the `reduced()`
config (compute dtype f32).
Jobs (m clients, every array leading with m):
- `mix_flat`: `make_ppermute_mix_flat` on "flat" (m, d) and "mu" (m,),
  rounds t < meta.rounds of the exponential schedule, each mixing the
  last one's output -> "flat/t", "mu/t"; meta.wire_dtype narrows the wire;
- `mix_tree`: `make_ppermute_mix` on the tree "params/<path>" whose
  shared leaves are meta.shared, chained the same way -> "params/t/<path>",
  "mu/t";
- `matrix`: `make_matrix_mix_flat` on "flat", "mu" under the tables
  "idx/t", "w/t", chained -> "flat/t", "mu/t";
- `rounds`: meta.rounds resident rounds of `steps.build_train_algo` at
  `reduced()` meta.arch (gossip meta.gossip, topology meta.topology) from
  the state "flat", "mu", "mom_u", "personal/<path>", "mom_v/<path>",
  with batches "b/t/{v,u}/{tokens,labels}" and (matrix) tables "idx/t",
  "w/t" -> the final state's leaves under the same names, and with
  meta.telemetry each round's scalar metrics (the gauges among them) as
  "metrics/t/<name>"; meta.graph_seed adds one collaboration-graph record
  of the final state (`obs.graph.emit_graph_record`, seed graph_seed, t0
  meta.rounds - 1, the last round's actives when sampled) as
  "graph/<field>"; meta.trace adds each round's whole "flat/t", "mom_u/t"
  and "mu/t";
- `sampled_rounds`: the same from the same state with the round's sorted
  active ids "active/t" and its induced compact tables "idx/t", "w/t"
  (n_active rows; batches "b/t/..." compact too, each rank keeping its
  own compact rows), `round_fn_sampled` across ranks (topology
  meta.topology names the spec's schedule only);
- `tree_rounds`: meta.rounds tree-form rounds (gossip "ppermute", the
  exponential schedule) from "params/<path>", "mu", "mom_u/<path>",
  "mom_v/<path>" (the momentum trees' placeholder leaves (m,)) and the
  batches -> the final state's leaves under the same names;
- `tp_loss`: each client's loss on the rank's shards of "params/<path>"
  and the batch "tokens", "labels" (and a vlm's "vision", an encdec's
  "frames"), under
  `vmap(grad_and_value(...))` over the clients -> "loss" (m,) and the
  whole gradients "grad/<path>";
- `collectives`: one train step of `dryrun.count_collectives` on the
  rank's share (meta.gossip, meta.resident, meta.k_u, meta.k_v,
  meta.bf16_grads, meta.gossip_dtype; batch meta.batch at S meta.seq),
  from the family's init and random batches -> "counts", the JSON of
  rank 0's {op: {count, bytes}} on its model group (no input arrays).
The tests of the cross-rank mixes run these jobs on gloo and hold the
results against the JAX reference on the same arrays.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .. import tree
from ..core import dfedpgp, topology
from . import mesh as mesh_mod
from . import ranks, steps, tp

JOBS = ("mix_flat", "mix_tree", "matrix", "rounds", "sampled_rounds",
        "tree_rounds", "tp_loss", "collectives")


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _sub(data: dict, prefix: str) -> list:
    """[(path tuple, array)] of the keys under `prefix/`."""
    n = len(prefix) + 1
    return [(tuple(int(k) if k.isdigit() else k
                   for k in key[n:].split("/")), data[key])
            for key in sorted(data) if key.startswith(prefix + "/")]


def _gathered(x: torch.Tensor, mesh) -> np.ndarray:
    """The (m, ...) rows of every data index (a collective)."""
    return ranks.all_gather_rows(x, mesh.world,
                                 mesh.data_group).cpu().numpy()


def _tree_out(out: dict, name: str, tree_, mesh) -> None:
    for p, leaf in tree.paths(tree_):
        out[name + "/" + "/".join(map(str, p))] = _gathered(leaf, mesh)


def _config(meta: dict):
    from ..configs import get_reduced
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta.get("cfg", {}).items()}
    return get_reduced(meta["arch"]).replace(compute_dtype="float32",
                                             **fields)


def _batch(data: dict, prefix: str, dev, lo: int, hi: int) -> dict:
    """The batch leaves under `prefix` (tokens and labels as int64; a
    vlm's "vision", an encdec's "frames"), the rows [lo, hi)."""
    out = {}
    for name in ("tokens", "labels", "vision", "frames"):
        key = prefix + name
        if key in data:
            x = _tensor(data[key], dev)[lo:hi]
            out[name] = x if name in ("vision", "frames") else x.long()
    return out


def _layout(m: int):
    return mesh_mod.one_device_layout(m, 1)


def _mix_job(job: str, meta: dict, data: dict, mesh) -> dict:
    lo, hi = mesh.rows
    dev, m = mesh.device, mesh.n_clients
    mu = _tensor(data["mu"], dev)[lo:hi]
    wd = getattr(torch, meta["wire_dtype"]) if meta.get("wire_dtype") \
        else None
    sched = topology.TopologySchedule.exponential(m)
    out = {}
    if job == "mix_tree":
        params = tree.from_paths((p, _tensor(a, dev)[lo:hi])
                                 for p, a in _sub(data, "params"))
        shared = {tuple(int(k) if k.isdigit() else k for k in s.split("/"))
                  for s in meta["shared"]}
        mask = tree.from_paths((p, p in shared)
                               for p, _ in tree.paths(params))
        mix = steps.make_ppermute_mix(mesh, _layout(m), mask, params,
                                      wire_dtype=wd, schedule=sched)
        for t in range(meta["rounds"]):
            params, mu = mix(params, mu, dfedpgp.round_counter(t, dev))
            _tree_out(out, f"params/{t}", params, mesh)
            out[f"mu/{t}"] = _gathered(mu, mesh)
        return out
    flat = _tensor(data["flat"], dev)[lo:hi]
    if job == "mix_flat":
        mix = steps.make_ppermute_mix_flat(mesh, _layout(m), flat.shape[1],
                                           wire_dtype=wd, schedule=sched)
    else:
        mix = steps.make_matrix_mix_flat(mesh, _layout(m), wire_dtype=wd)
    for t in range(meta["rounds"]):
        P = None
        if job == "matrix":
            P = topology.SparseTopology(torch.from_numpy(data[f"idx/{t}"]),
                                        torch.from_numpy(data[f"w/{t}"]))
        flat, mu = mix(flat, mu, dfedpgp.round_counter(t, dev), P)
        out[f"flat/{t}"], out[f"mu/{t}"] = (_gathered(flat, mesh),
                                            _gathered(mu, mesh))
    return out


def _rounds_job(job: str, meta: dict, data: dict, mesh) -> dict:
    from ..obs import gauges
    from ..spec import make_algo_spec
    lo, hi = mesh.rows
    dev, m = mesh.device, mesh.n_clients
    resident = job != "tree_rounds"
    sampled = job == "sampled_rounds"
    cfg = _config(meta)
    spec = make_algo_spec("dfedpgp", topology=meta["topology"],
                          n_neighbors=meta.get("n_neighbors", 2), seed=0,
                          gossip=meta["gossip"], resident=resident,
                          telemetry=bool(meta.get("telemetry")))
    algo, _, _, flat_layout = steps.build_train_algo(
        cfg, mesh, _layout(m), spec=spec, lr=0.02)
    shards = algo.tp

    def rows(prefix):
        return tree.from_paths((p, _tensor(a, dev)[lo:hi])
                               for p, a in _sub(data, prefix))

    rnd = dfedpgp.round_counter(0, dev)
    mu = _tensor(data["mu"], dev)[lo:hi]
    if resident:
        state = shards.shard_state(dfedpgp.FlatDFedPGPState(
            flat=_tensor(data["flat"], dev)[lo:hi],
            personal=rows("personal"), mu=mu,
            opt_u=dfedpgp.SGDState(_tensor(data["mom_u"], dev)[lo:hi]),
            opt_v=dfedpgp.SGDState(rows("mom_v")), round=rnd))
    else:
        state = dfedpgp.DFedPGPState(
            params=shards.shard(rows("params")), mu=mu,
            opt_u=dfedpgp.SGDState(shards.shard(rows("mom_u"))),
            opt_v=dfedpgp.SGDState(shards.shard(rows("mom_v"))),
            round=rnd)
    out, active = {}, None
    for t in range(meta["rounds"]):
        a, b_ = lo, hi
        if sampled:
            active = data[f"active/{t}"].tolist()
            bounds = ranks.compact_bounds(active, m, mesh.world)
            a, b_ = bounds[mesh.data_index], bounds[mesh.data_index + 1]
        b = {part: _batch(data, f"b/{t}/{part}/", dev, a, b_)
             for part in "vu"}
        P = None
        if meta["gossip"] == "matrix":
            P = topology.SparseTopology(torch.from_numpy(data[f"idx/{t}"]),
                                        torch.from_numpy(data[f"w/{t}"]))
        if sampled:
            state, metrics = algo.round_fn_sampled(state, P, active, b,
                                                   flat_layout)
        elif resident:
            state, metrics = algo.round_fn_flat(state, P, b, flat_layout)
        else:
            state, metrics = algo.round_fn(state, P, b)
        if meta.get("telemetry"):
            for k, v in gauges.to_host(metrics).items():
                out[f"metrics/{t}/{k}"] = np.asarray(v)
        if meta.get("trace"):
            whole = shards.unshard_state(state)
            out[f"flat/{t}"] = _gathered(whole.flat, mesh)
            out[f"mom_u/{t}"] = _gathered(whole.opt_u.momentum, mesh)
            out[f"mu/{t}"] = _gathered(state.mu, mesh)
    if meta.get("graph_seed") is not None:
        out.update(_graph(meta, state, algo, mesh, active))
    out["mu"] = _gathered(state.mu, mesh)
    if resident:
        state = shards.unshard_state(state)
        out["flat"] = _gathered(state.flat, mesh)
        out["mom_u"] = _gathered(state.opt_u.momentum, mesh)
        trees = (("personal", state.personal),
                 ("mom_v", state.opt_v.momentum))
    else:
        trees = (("params", shards.unshard(state.params)),
                 ("mom_u", shards.unshard(state.opt_u.momentum)),
                 ("mom_v", shards.unshard(state.opt_v.momentum)))
    for name, t in trees:
        _tree_out(out, name, t, mesh)
    return out


def _graph(meta: dict, state, algo, mesh, active) -> dict:
    """One graph record of the rank's block of the final state, emitted on
    every rank (only rank 0's sink keeps it) -> {"graph/<field>": value}
    of its numbers."""
    from ..obs import graph, sink as sink_mod
    from ..spec import make_algo_spec
    spec = make_algo_spec("dfedpgp", topology=meta["topology"],
                          n_neighbors=meta.get("n_neighbors", 2), seed=0)
    ring = sink_mod.RingSink()
    t0 = meta["rounds"] - 1
    graph.emit_graph_record(
        ring, run_id="ranks_check", algo="dfedpgp", m=mesh.n_clients,
        seed=meta["graph_seed"], schedule=spec.schedule(mesh.n_clients),
        step=t0, t0=t0, flat=state.flat, mu=state.mu,
        personal=state.personal, active=active, ranks=algo.across_ranks)
    rec = ring.last("graph")
    return {f"graph/{k}": np.asarray(v) for k, v in rec.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def _loss_job(meta: dict, data: dict, mesh) -> dict:
    from torch.func import grad_and_value, vmap
    from ..models import get_model
    lo, hi = mesh.rows
    dev = mesh.device
    cfg = _config(meta)
    params = tree.from_paths((p, _tensor(a, dev)[lo:hi])
                             for p, a in _sub(data, "params"))
    template = tree.tree_map(lambda a: a[0], params)
    shards = tp.Executor(cfg, mesh, template)
    loss_fn = shards.loss_fn(get_model(cfg), cfg)
    grads, loss = vmap(grad_and_value(loss_fn))(
        shards.shard(params), _batch(data, "", dev, lo, hi))
    out = {"loss": _gathered(loss, mesh)}
    _tree_out(out, "grad", shards.unshard(grads), mesh)
    return out


def _collectives_job(meta: dict, mesh) -> dict:
    import dataclasses
    from ..configs import SHAPES
    from .dryrun import count_collectives
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=meta["seq"])
    counts = count_collectives(
        _config(meta), mesh, shape, per_client_batch=meta["batch"],
        device=mesh.device, **{k: meta[k] for k in (
            "gossip", "resident", "k_u", "k_v", "bf16_grads",
            "gossip_dtype") if k in meta})
    return {"counts": np.array(json.dumps(counts))}


def _rank(rank: int, jobs, world: int, init_file: str, device: str) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ranks.init(rank, world, init_file, device)
    try:
        for job, inp, out in jobs:
            data = dict(np.load(inp))
            meta = json.loads(str(data.pop("meta")))
            mesh = mesh_mod.make_host_mesh(meta["m"],
                                           model=meta.get("tp", 1))
            if job in ("rounds", "sampled_rounds", "tree_rounds"):
                res = _rounds_job(job, meta, data, mesh)
            elif job == "tp_loss":
                res = _loss_job(meta, data, mesh)
            elif job == "collectives":
                res = _collectives_job(meta, mesh)
            else:
                res = _mix_job(job, meta, data, mesh)
            if rank == 0:
                np.savez(out, **res)
    finally:
        ranks.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "ranks_check", description=__doc__)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: NCCL, a rank a card) or 'cpu' "
                         "(gloo)")
    ap.add_argument("--job", nargs=3, action="append", required=True,
                    metavar=("JOB", "IN", "OUT"))
    args = ap.parse_args(argv)
    bad = [j for j, _, _ in args.job if j not in JOBS]
    if bad:
        ap.error(f"unknown jobs {bad}; known: {JOBS}")
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.spawn(_rank, args=(args.job, args.world,
                              os.path.join(tmp, "rendezvous"), args.device),
                 nprocs=args.world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
