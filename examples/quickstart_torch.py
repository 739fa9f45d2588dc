"""Quickstart on the PyTorch port: DFedPGP vs Local vs FedAvg on
synthetic non-IID data (the twin of `examples/quickstart.py`).

16 clients, Dirichlet(0.3) partition, 20 rounds through
`repro_torch.fl.simulator.run_experiment`, the same `SimConfig` as the
JAX quickstart: directed partial gradient push against purely-local
training and a single consensus model, by personalized accuracy.  Runs
on the card unless `--device cpu` asks for the plain torch path.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.fl.simulator import SimConfig, run_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)
    sim = SimConfig(m=16, rounds=20, n_neighbors=4, n_train=64, n_test=32,
                    batch=16, k_local=2, k_personal=1,
                    dist="dirichlet", alpha=0.3)
    print(f"{sim.m} clients, Dirichlet({sim.alpha}), {sim.rounds} rounds\n")
    results = {}
    for algo in ("local", "fedavg", "dfedpgp"):
        h = run_experiment(algo, sim, device=args.device, eval_every=5,
                           verbose=True)
        results[algo] = h["final_acc"]
    print("\npersonalized test accuracy:")
    for algo, acc in sorted(results.items(), key=lambda kv: -kv[1]):
        print(f"  {algo:10s} {acc:.4f}")
    return results


if __name__ == "__main__":
    main()
