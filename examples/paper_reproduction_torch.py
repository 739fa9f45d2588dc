"""The paper's experimental protocol on the PyTorch port, end to end
at sim scale (the twin of `examples/paper_reproduction.py`).

Trains personalized models across the baseline set on a non-IID
partition through `repro_torch.fl.simulator.run_experiment`, with the
same `SimConfig` as the JAX script, and writes every history as JSON.
Runs on the card unless `--device cpu` asks for the plain torch path.

  PYTHONPATH=src python examples/paper_reproduction_torch.py \
      [--rounds 200] [--clients 24] [--algos dfedpgp,fedrep,dfedavgm] \
      [--dist dirichlet --alpha 0.3 | --dist pathological --c 2] \
      [--device cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.fl.simulator import ALGOS, SimConfig, run_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--algos", default="local,fedavg,fedrep,dfedavgm,osgp,"
                                       "dfedpgp")
    ap.add_argument("--dist", default="dirichlet",
                    choices=["dirichlet", "pathological"])
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--c", type=int, default=2)
    ap.add_argument("--out",
                    default="examples/out/paper_reproduction_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)

    sim = SimConfig(m=args.clients, rounds=args.rounds, n_neighbors=4,
                    n_train=64, n_test=32, batch=16, k_local=5,
                    k_personal=1, dist=args.dist, alpha=args.alpha, c=args.c)
    histories = {}
    for algo in args.algos.split(","):
        if algo not in ALGOS:
            ap.error(f"unknown {algo}; known {ALGOS}")
        histories[algo] = run_experiment(algo, sim, device=args.device,
                                         eval_every=10, verbose=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(histories, indent=1, default=float))
    print(f"\nfinal personalized accuracy "
          f"({args.dist}-{args.alpha if args.dist == 'dirichlet' else args.c}):")
    for algo, h in sorted(histories.items(),
                          key=lambda kv: -kv[1]["final_acc"]):
        print(f"  {algo:10s} {h['final_acc']:.4f}")
    print(f"histories -> {out}")
    return histories


if __name__ == "__main__":
    main()
