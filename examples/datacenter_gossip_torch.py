"""Regime B on the PyTorch port: decentralized directed training of a
transformer LM (the twin of `examples/datacenter_gossip.py`).

Each client holds a personalized copy of an LM; the shared body gossips
over a time-varying directed graph (the lm_head never moves).  Runs the
port's trainer, `repro_torch.launch.train`, with the JAX demo's
arguments on a reduced --arch config; `python -m
repro_torch.launch.dryrun` places the same step on the production
meshes.  Runs on the card unless `--device cpu` asks for the CPU.

  PYTHONPATH=src python examples/datacenter_gossip_torch.py \
      [--arch xlstm-125m] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return train.main(["--arch", args.arch, "--reduced", "--rounds",
                       str(args.rounds), "--clients", "4", "--batch", "2",
                       "--seq", "64", "--neighbors", "2", "--device",
                       args.device])


if __name__ == "__main__":
    main()
