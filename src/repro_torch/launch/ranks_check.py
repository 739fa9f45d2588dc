"""Cross-rank mixes and rounds on arrays from files, over W spawned ranks.

    python -m repro_torch.launch.ranks_check --world W [--device cpu|cuda] \\
        --job JOB IN.npz OUT.npz [--job JOB IN.npz OUT.npz ...]

Every rank joins one process group (`ranks.init`, a file rendezvous in a
fresh temporary directory) and runs the jobs in turn: each takes its
block of the client rows, and rank 0 writes the blocks gathered back in
row order.  IN.npz holds the arrays and, under "meta", a JSON object of
the job's settings.
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
  "w/t" -> the final state's leaves under the same names.
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
from . import ranks, steps

JOBS = ("mix_flat", "mix_tree", "matrix", "rounds")


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _sub(data: dict, prefix: str) -> list:
    """[(path tuple, array)] of the keys under `prefix/`."""
    n = len(prefix) + 1
    return [(tuple(int(k) if k.isdigit() else k
                   for k in key[n:].split("/")), data[key])
            for key in sorted(data) if key.startswith(prefix + "/")]


def _gathered(x: torch.Tensor, world: int) -> np.ndarray:
    return ranks.all_gather_rows(x, world).cpu().numpy()


def _layout(m: int):
    return mesh_mod.one_device_layout(m, 1)


def _mix_job(job: str, meta: dict, data: dict, mesh) -> dict:
    lo, hi = mesh.rows
    dev, m, world = mesh.device, mesh.n_clients, mesh.world
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
            for p, leaf in tree.paths(params):
                out[f"params/{t}/" + "/".join(map(str, p))] = \
                    _gathered(leaf, world)
            out[f"mu/{t}"] = _gathered(mu, world)
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
        out[f"flat/{t}"], out[f"mu/{t}"] = (_gathered(flat, world),
                                            _gathered(mu, world))
    return out


def _rounds_job(meta: dict, data: dict, mesh) -> dict:
    from ..configs import get_reduced
    from ..spec import make_algo_spec
    lo, hi = mesh.rows
    dev, m, world = mesh.device, mesh.n_clients, mesh.world
    cfg = get_reduced(meta["arch"]).replace(compute_dtype="float32")
    spec = make_algo_spec("dfedpgp", topology=meta["topology"],
                          n_neighbors=meta.get("n_neighbors", 2), seed=0,
                          gossip=meta["gossip"], resident=True)
    algo, _, _, flat_layout = steps.build_train_algo(
        cfg, mesh, _layout(m), spec=spec, lr=0.02)

    def rows(prefix):
        return tree.from_paths((p, _tensor(a, dev)[lo:hi])
                               for p, a in _sub(data, prefix))

    state = dfedpgp.FlatDFedPGPState(
        flat=_tensor(data["flat"], dev)[lo:hi], personal=rows("personal"),
        mu=_tensor(data["mu"], dev)[lo:hi],
        opt_u=dfedpgp.SGDState(_tensor(data["mom_u"], dev)[lo:hi]),
        opt_v=dfedpgp.SGDState(rows("mom_v")),
        round=dfedpgp.round_counter(0, dev))
    for t in range(meta["rounds"]):
        b = {part: {name: _tensor(data[f"b/{t}/{part}/{name}"],
                                  dev).long()[lo:hi]
                    for name in ("tokens", "labels")} for part in "vu"}
        P = None
        if meta["gossip"] == "matrix":
            P = topology.SparseTopology(torch.from_numpy(data[f"idx/{t}"]),
                                        torch.from_numpy(data[f"w/{t}"]))
        state, _ = algo.round_fn_flat(state, P, b, flat_layout)
    out = {"flat": _gathered(state.flat, world),
           "mu": _gathered(state.mu, world),
           "mom_u": _gathered(state.opt_u.momentum, world)}
    for name, t in (("personal", state.personal),
                    ("mom_v", state.opt_v.momentum)):
        for p, leaf in tree.paths(t):
            out[name + "/" + "/".join(map(str, p))] = _gathered(leaf, world)
    return out


def _rank(rank: int, jobs, world: int, init_file: str, device: str) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ranks.init(rank, world, init_file, device)
    try:
        for job, inp, out in jobs:
            data = dict(np.load(inp))
            meta = json.loads(str(data.pop("meta")))
            mesh = mesh_mod.make_host_mesh(meta["m"])
            res = _rounds_job(meta, data, mesh) if job == "rounds" \
                else _mix_job(job, meta, data, mesh)
            if rank == 0:
                np.savez(out, **res)
    finally:
        ranks.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "ranks_check", description=__doc__)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", default="cpu")
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
