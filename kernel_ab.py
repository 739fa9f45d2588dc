#!/usr/bin/env python3
"""Time the serve and codec kernels of one checkout of the port on one GPU.

    python3 kernel_ab.py                         # this checkout's src/
    python3 kernel_ab.py --src OTHER/src --tag parent

Builds `head_gather` and `topk_gather` from the given tree's csrc/ and
prints one JSON line: the card's name and power limit, then the device
time per call (torch.profiler, 50 calls, inputs warm in L2) and the cold
time (L2 flushed by a 256 MB copy before each call) of
`ops.head_gather_matmul` at the serve shapes (m 100, d 64, n 10, f32,
B 1, 64 and 1024) and of `ops.topk_gather` at the codec shapes (K 833 of
d 13,328, f32 values, uint16 columns; the random topology's wire table
at m 100, k 11 and m 1024, k 16), with the same inputs as
chip_smoke.py's `timings` phase.  To compare two trees, run both in one
session on one card, in turns: parent, change, change, parent.  Exits
nonzero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parent
    ap.add_argument("--src", default=str(here / "src"),
                    help="the src/ directory of the checkout to time")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import chip_smoke as cs                  # the timing helpers
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import _build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("head_gather", "topk_gather"))

    out = {"tag": args.tag, "src": args.src, "card": cs.nvidia_smi_line(),
           "head_gather_matmul": {}, "topk_gather": {}}
    m, d, n = 100, 64, 10
    W = torch.randn((m, d, n), device="cuda")
    bias = torch.randn((m, n), device="cuda")
    for B in (1, 64, 1024):
        uid = torch.randint(0, m, (B,), device="cuda", dtype=torch.int32)
        H = torch.randn((B, d), device="cuda")

        def head():
            return ops.head_gather_matmul(uid, H, W, bias, force="cuda")

        out["head_gather_matmul"][B] = {"ms": cs.device_ms(torch, head),
                                        "cold_ms": cs.cold_ms(torch, head)}
    for m, nb in ((100, 10), (1024, 15)):
        d, K = 13328, 833
        Pw = gossip.wire_only(topology.get_schedule("random", m, nb, 0).at(0))
        idx, w = Pw.idx.cuda(), Pw.w.cuda().contiguous()
        k = idx.shape[1]
        _, _, vals, cols = cs._payload_case(torch, m, k, d, K, 13,
                                            torch.float32, torch.uint16)

        def topk():
            return ops.topk_gather(idx, w, vals, cols, d, force="cuda")

        out["topk_gather"][f"{m}x{k}"] = {"ms": cs.device_ms(torch, topk),
                                          "cold_ms": cs.cold_ms(torch, topk)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
