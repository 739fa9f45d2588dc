"""Small CNN classifier of the FL simulation (port of `repro/models/cnn.py`).

Same parameters and the same function as the reference: conv kernels are
HWIO and activations NHWC at every public function, so parameter dicts
and flat buffers carry over unchanged.  Internally the convolutions run in
PyTorch's NCHW layout; the kernel is permuted only at the `F.conv2d` call
and the activation is flattened in NHWC order before `dense`, as the
reference's reshape does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import layers as L


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    image_size: int = 8
    channels: int = 3
    n_classes: int = 10
    widths: Tuple[int, int] = (16, 32)
    d_feature: int = 64
    gn_groups: int = 4


def _conv_init(generator, shape, device):       # (..., kh, kw, cin, cout)
    fan_in = shape[-4] * shape[-3] * shape[-2]
    return (torch.randn(tuple(shape), generator=generator)
            / math.sqrt(fan_in)).to(device)


def init_params(generator: torch.Generator, cfg: CNNConfig,
                batch_shape: tuple = (), device="cpu") -> dict:
    """Random parameters from `generator`; `batch_shape=(m,)` draws m
    stacked client models at once."""
    c1, c2 = cfg.widths
    feat_dim = c2 * (cfg.image_size // 4) ** 2
    bs = tuple(batch_shape)

    def const(val, n):
        return torch.full(bs + (n,), val, dtype=torch.float32, device=device)

    return {
        "features": {
            "conv1": _conv_init(generator, bs + (3, 3, cfg.channels, c1),
                                device),
            "gn1": const(1.0, c1),
            "gb1": const(0.0, c1),
            "conv2": _conv_init(generator, bs + (3, 3, c1, c2), device),
            "gn2": const(1.0, c2),
            "gb2": const(0.0, c2),
            "dense": L.dense_init(generator, bs + (feat_dim, cfg.d_feature),
                                  device=device),
        },
        "classifier": {
            "w": L.dense_init(generator, bs + (cfg.d_feature, cfg.n_classes),
                              device=device),
            "b": const(0.0, cfg.n_classes),
        },
    }


def _gn(x, w, b, groups):
    """GroupNorm over NCHW x with groups of consecutive channels (the
    reference groups the channels-last axis the same way): biased
    variance, eps 1e-5."""
    B, C, H, W = x.shape
    xg = x.reshape(B, groups, C // groups, H, W)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(B, C, H, W) * w[:, None, None] + b[:, None, None]


def _conv(x, w_hwio):
    """SAME-padded stride-1 conv of NCHW x with an HWIO kernel."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding="same")


def features(p: dict, x: torch.Tensor, cfg: CNNConfig) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> (B, d_feature)."""
    f = p["features"]
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_gn(_conv(x, f["conv1"]), f["gn1"], f["gb1"], cfg.gn_groups))
    x = F.max_pool2d(x, 2, 2)
    x = F.relu(_gn(_conv(x, f["conv2"]), f["gn2"], f["gb2"], cfg.gn_groups))
    x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC flatten
    return F.relu(x @ f["dense"])


def logits_fn(p: dict, x: torch.Tensor, cfg: CNNConfig) -> torch.Tensor:
    h = features(p, x, cfg)
    return h @ p["classifier"]["w"] + p["classifier"]["b"]


def loss_fn(p: dict, batch: dict, cfg: CNNConfig) -> torch.Tensor:
    return L.softmax_xent(logits_fn(p, batch["x"], cfg), batch["y"])


def accuracy(p: dict, x: torch.Tensor, y: torch.Tensor,
             cfg: CNNConfig) -> torch.Tensor:
    pred = torch.argmax(logits_fn(p, x, cfg), dim=-1)
    return (pred == y).to(torch.float32).mean()
