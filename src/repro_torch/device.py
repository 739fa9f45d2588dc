"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device.  The port's entry points default to "cuda" and never
    continue on the CPU silently: without a GPU a CUDA request raises, and
    the caller must pass device="cpu" to run the plain path.  "meta"
    builds shapes and dtypes without data (the input structs of Regime
    B's `launch.steps`); nothing runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device {str(device)!r}: the port runs on 'cuda' "
                         f"or 'cpu' ('meta' for shapes only)")
    return dev


def seeded_generator(seed: int, stream: int, t: int,
                     device="cpu") -> torch.Generator:
    """A generator on `device` that is a pure function of (seed, stream,
    t): the port's counterpart of folding a round index into a
    `jax.random` key.  CPU and CUDA generators give different streams
    from one seed."""
    s = (int(seed) * 1_000_003 + int(stream) * 7_919 + int(t)) % (2 ** 63)
    return torch.Generator(device=torch.device(device)).manual_seed(s)
