"""The building blocks of `repro/models/layers.py` that the CNN uses."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: Optional[float] = None, device="cpu") -> torch.Tensor:
    """LeCun-normal style init on the penultimate dim (leading batch dims
    of `shape` beyond the weight's own two are allowed)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator) * s
    return x.to(dtype=dtype, device=device)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: int = -100) -> torch.Tensor:
    """Mean token cross-entropy; labels == ignore are masked out."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    w = (labels != ignore).to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
