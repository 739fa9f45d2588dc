"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device.  The port's entry points default to "cuda" and never
    continue on the CPU silently: without a GPU a CUDA request raises, and
    the caller must pass device="cpu" to run the plain path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {str(device)!r}: the port runs on 'cuda' "
                         f"or 'cpu'")
    return dev
