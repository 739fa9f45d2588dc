#!/usr/bin/env python3
"""Time the serve, codec and write-back kernels of one checkout of the
port on one GPU.

    python3 kernel_ab.py                         # this checkout's src/
    python3 kernel_ab.py --src OTHER/src --tag parent
    python3 kernel_ab.py --only gossip_scatter --sweep

Builds `head_gather`, `topk_gather` and `gossip_scatter` from the given
tree's csrc/ and prints one JSON line: the card's name and power limit,
then the device time per call (torch.profiler, 50 calls, inputs warm in
L2) and the cold time (L2 flushed by a 256 MB copy before each call) of
`ops.head_gather_matmul` at the serve shapes (m 100, d 64, n 10, f32,
B 1, 64 and 1024), of `ops.topk_gather` at the codec shapes (K 833 of
d 13,328, f32 values, uint16 columns; the random topology's wire table
at m 100, k 11 and m 1024, k 16), and of `ops.gossip_scatter` at the
sampled path's shape (m 100, n 25, d 13,328, f32) and at m 4096, n 1024,
with the same inputs as chip_smoke.py's `timings` phase.  Beside them the
sampled round's write-back at m 100 of 2 buffers (4 with a codec): one
`ops.gossip_scatter` call per buffer on a tree without
`ops.gossip_scatter_many`, one `gossip_scatter_many` call on a tree with
it, device ms and per-call ms through the wrappers (CUDA events).
`--sweep` adds the write-back kernel at those shapes for a range of
`block_d` (slots per thread, threads per block).  To compare two trees, run both in one
session on one card, in turns: parent, change, change, parent.  Exits
nonzero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


KERNELS = ("head_gather_matmul", "topk_gather", "gossip_scatter")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    here = Path(__file__).resolve().parent
    ap.add_argument("--src", default=str(here / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--only", default=",".join(KERNELS),
                    help=f"comma-separated subset of {KERNELS}")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the write-back kernel's tilings")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    unknown = set(only) - set(KERNELS)
    if unknown:
        ap.error(f"--only {sorted(unknown)}: known {KERNELS}")

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import chip_smoke as cs                  # the timing helpers
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(tuple({"head_gather_matmul": "head_gather"}.get(k, k)
                       for k in only))

    out = {"tag": args.tag, "src": args.src, "card": cs.nvidia_smi_line()}
    if "head_gather_matmul" in only:
        out["head_gather_matmul"] = _head(torch, cs)
    if "topk_gather" in only:
        out["topk_gather"] = _topk(torch, cs)
    if "gossip_scatter" in only:
        out["gossip_scatter"] = _scatter(torch, cs, args.sweep)
    print(json.dumps(out), flush=True)
    return 0


def _head(torch, cs) -> dict:
    from repro_torch.kernels import ops
    res = {}
    m, d, n = 100, 64, 10
    W = torch.randn((m, d, n), device="cuda")
    bias = torch.randn((m, n), device="cuda")
    for B in (1, 64, 1024):
        uid = torch.randint(0, m, (B,), device="cuda", dtype=torch.int32)
        H = torch.randn((B, d), device="cuda")

        def head():
            return ops.head_gather_matmul(uid, H, W, bias, force="cuda")

        res[B] = {"ms": cs.device_ms(torch, head),
                  "cold_ms": cs.cold_ms(torch, head)}
    return res


def _topk(torch, cs) -> dict:
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import ops
    res = {}
    for m, nb in ((100, 10), (1024, 15)):
        d, K = 13328, 833
        Pw = gossip.wire_only(topology.get_schedule("random", m, nb, 0).at(0))
        idx, w = Pw.idx.cuda(), Pw.w.cuda().contiguous()
        k = idx.shape[1]
        _, _, vals, cols = cs._payload_case(torch, m, k, d, K, 13,
                                            torch.float32, torch.uint16)

        def topk():
            return ops.topk_gather(idx, w, vals, cols, d, force="cuda")

        res[f"{m}x{k}"] = {"ms": cs.device_ms(torch, topk),
                           "cold_ms": cs.cold_ms(torch, topk)}
    return res


def _scatter_inputs(torch, m, n, d, buffers, seed=12):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randperm(m, generator=g, device="cuda")[:n].sort()[0].to(
        torch.int32)
    Xs = [torch.randn((n, d), generator=g, device="cuda")
          for _ in range(buffers)]
    Us = [torch.randn((m, d), generator=g, device="cuda")
          for _ in range(buffers)]
    return rows, Xs, Us


def _scatter(torch, cs, sweep: bool) -> dict:
    from repro_torch.kernels import ops
    one = torch.zeros(1, device="cuda")
    res = {"launch_floor_ms": cs.device_ms(torch, lambda: one.add_(1.0))}
    d = 13328
    for m, n in ((100, 25), (4096, 1024)):
        rows, (X,), (U,) = _scatter_inputs(torch, m, n, d, 1)

        def single():
            return ops.gossip_scatter(rows, X, U, force="cuda")

        res[f"{m}x{n}"] = {"ms": cs.device_ms(torch, single),
                           "cold_ms": cs.cold_ms(torch, single),
                           "call_ms": cs.time_ms(torch, single)}
    # the sampled round's write-back at m 100: 2 buffers, 4 with a codec
    many = hasattr(ops, "gossip_scatter_many")
    for buffers in (2, 4):
        rows, Xs, Us = _scatter_inputs(torch, 100, 25, d, buffers)
        if many:
            def writeback():
                ops.gossip_scatter_many(rows, Xs, Us, force="cuda")
        else:
            def writeback():
                for X, U in zip(Xs, Us):
                    ops.gossip_scatter(rows, X, U, force="cuda")
        res[f"writeback_{buffers}"] = {
            "form": "gossip_scatter_many" if many else
                    f"{buffers} x gossip_scatter",
            "ms": cs.device_ms(torch, writeback),
            "cold_ms": cs.cold_ms(torch, writeback),
            "call_ms": cs.time_ms(torch, writeback)}
    if sweep:
        res["sweep"] = _scatter_sweep(torch, cs)
    return res


def _scatter_sweep(torch, cs) -> dict:
    """Device ms of the write-back kernel at each block_d it takes (1 to
    8 slots per thread and pair, 128 to 256 threads), each checked against
    the plain version."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import gossip_scatter as gs
    sms = _build.sm_count("cuda")
    d, out = 13328, {}
    for m, n, buffers in ((100, 25, 1), (100, 25, 2), (100, 25, 4),
                          (4096, 1024, 1)):
        rows, Xs, Us = _scatter_inputs(torch, m, n, d, buffers)
        case = {"default": gs.plan(n, d, sms, buffers)._asdict()}
        want = [U.clone() for U in Us]
        for X, U in zip(Xs, want):
            U[rows.long()] = X
        widths = [bd for bd in (512, 1024, 2048, 4096, 8192)
                  if bd <= 4 * gs.THREADS * gs.max_vecs(buffers)]
        for bd in widths:
            got = [U.clone() for U in Us]

            def run(bd=bd, got=got):
                ops.gossip_scatter_many(rows, Xs, got, force="cuda",
                                        block_d=bd)

            run()
            torch.cuda.synchronize()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"sweep {m}x{n}x{buffers} block_d {bd} disagrees")
            p = gs.plan(n, d, sms, buffers, bd)
            case[bd] = {"ms": cs.device_ms(torch, run), "vecs": p.vecs,
                        "threads": p.threads, "blocks": p.blocks}
        out[f"{m}x{n}x{buffers}"] = case
    return out


if __name__ == "__main__":
    sys.exit(main())
