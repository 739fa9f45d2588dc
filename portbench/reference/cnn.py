"""The simulator's small CNN, one client, plain PyTorch.  It is the
repo's CPU-scale stand-in for the paper's ResNet-18 with GroupNorm, not
that model: 3x3 conv (SAME) -> GroupNorm -> ReLU -> 2x2 max-pool, twice,
then a dense layer with ReLU and a linear head; cross-entropy loss.

Parameters are keyed by path ('features/conv1', ...): conv kernels HWIO,
images NHWC, the pooled activation flattened in NHWC order before the
dense layer.  GroupNorm takes groups of consecutive channels, the biased
variance and eps 1e-5.  `dtype` is the compute precision: float32 is the
reference (TF32 off: `harness` turns it off around the reference), and
bfloat16 its control, with the norms' statistics and the loss in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _group_norm(x, w, b, groups: int, dtype):
    B, C, H, W = x.shape
    xg = x.to(torch.float32).reshape(B, groups, C // groups, H, W)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(B, C, H, W)
    return (xg * w[:, None, None] + b[:, None, None]).to(dtype)


def loss(p: dict, batch: dict, cfg: dict, dtype=torch.float32):
    """Mean cross-entropy of one client's batch {'x': (B, H, W, C), 'y':
    (B,)} under its parameters `p`."""
    groups = cfg["gn_groups"]

    def conv(x, w):
        return F.conv2d(x, w.to(dtype).permute(3, 2, 0, 1), padding=1)

    x = batch["x"].to(dtype).permute(0, 3, 1, 2)
    x = _group_norm(conv(x, p["features/conv1"]), p["features/gn1"],
                    p["features/gb1"], groups, dtype)
    x = F.max_pool2d(F.relu(x), 2)
    x = _group_norm(conv(x, p["features/conv2"]), p["features/gn2"],
                    p["features/gb2"], groups, dtype)
    x = F.max_pool2d(F.relu(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = F.relu(x @ p["features/dense"].to(dtype))
    logits = h @ p["classifier/w"].to(dtype) + p["classifier/b"].to(dtype)
    return F.cross_entropy(logits.to(torch.float32), batch["y"])
