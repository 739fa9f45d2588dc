"""Serving on the PyTorch port: checkpoint in, mixed-user batched decode
out (the twin of `examples/serve_decode.py`).

`repro_torch.serve.decode` is the port of the JAX demo: it "trains" an
m-client DFedPGP fleet on the resident buffer, checkpoints it, restores
a `ServingState` (the consensus trunk unraveled once, the personal
final_norm and lm_head stacked per user) and decodes a batch that mixes
users: the trunk once per step for the whole batch, each request's head
through `ops.head_gather_matmul` (the CUDA kernel on the card).  Runs on
the card unless `--device cpu` asks for the plain torch path.

  PYTHONPATH=src python examples/serve_decode_torch.py \
      [--arch qwen2-0.5b] [--tokens 16] [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.serve import decode


def main(argv=None):
    """`repro_torch.serve.decode.main`: --arch, --tokens, --batch and
    --clients as in the JAX demo, and --device."""
    return decode.main(argv)


if __name__ == "__main__":
    sys.exit(main())
