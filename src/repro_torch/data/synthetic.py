"""Synthetic image-classification data + the paper's non-IID partitioners,
and synthetic LM token batches.

Port of `repro/data/synthetic.py`: each class has a smooth random template
image; samples are template + noise, times a random brightness.  Labels
per client follow Dirichlet(alpha) or Pathological(c) proportions, and
test data uses the same per-client distribution as train (paper §5.1).

Standalone runs draw from a numpy Generator seeded by the caller (host
side, in bulk, then moved to the device).  It cannot replay `jax.random`:
parity runs hand the reference's arrays in
(`fl.simulator.run_experiment(data=)`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class ClientData(NamedTuple):
    x: torch.Tensor           # (m, n, H, W, C) f32
    y: torch.Tensor           # (m, n) int64
    x_test: torch.Tensor      # (m, n_test, H, W, C)
    y_test: torch.Tensor      # (m, n_test)
    label_probs: torch.Tensor  # (m, n_classes)

    def to(self, device) -> "ClientData":
        return ClientData(*(t.to(device) for t in self))


def from_arrays(x, y, x_test, y_test, label_probs, device="cpu"):
    """ClientData from array-likes (e.g. the reference's numpy arrays)."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return ClientData(t(x, torch.float32), t(y, torch.int64),
                      t(x_test, torch.float32), t(y_test, torch.int64),
                      t(label_probs, torch.float32))


def _rng(seed: int) -> np.random.Generator:
    # host-side numpy stream for bulk synthetic data, seeded by the caller
    return np.random.default_rng(seed)  # noqa: TID251


def _class_templates(rng, n_classes: int, size: int, channels: int):
    """Smooth random template per class (bilinear upsample of a coarse
    half-resolution pattern), (n_classes, size, size, channels)."""
    coarse = torch.as_tensor(
        rng.standard_normal((n_classes, channels, size // 2, size // 2)),
        dtype=torch.float32)
    templ = F.interpolate(coarse, size=(size, size), mode="bilinear",
                          align_corners=False)
    return templ.permute(0, 2, 3, 1) * 1.5


def dirichlet_probs(rng, m: int, n_classes: int, alpha: float):
    return rng.dirichlet(np.full((n_classes,), alpha), size=m)


def pathological_probs(rng, m: int, n_classes: int, c: int):
    """Each client: c active classes, uniform over them."""
    probs = np.zeros((m, n_classes))
    for i in range(m):
        cls = rng.choice(n_classes, size=min(c, n_classes), replace=False)
        probs[i, cls] = 1.0 / len(cls)
    return probs


def make_client_data(rng, label_probs, n_train: int, n_test: int,
                     size: int = 8, channels: int = 3,
                     noise: float = 0.7) -> ClientData:
    m, n_classes = label_probs.shape
    templates = _class_templates(rng, n_classes, size, channels)

    def sample_split(n):
        cum = np.cumsum(label_probs, axis=1)
        u = rng.random((m, n, 1))
        y = np.minimum((u > cum[:, None, :]).sum(-1), n_classes - 1)
        x = templates[torch.as_tensor(y)]                  # (m, n, H, W, C)
        x = x + noise * torch.as_tensor(rng.standard_normal(x.shape),
                                        dtype=torch.float32)
        x = x * torch.as_tensor(0.8 + 0.4 * rng.random((m, n, 1, 1, 1)),
                                dtype=torch.float32)
        return x.to(torch.float32), torch.as_tensor(y, dtype=torch.int64)

    x, y = sample_split(n_train)
    xt, yt = sample_split(n_test)
    return ClientData(x, y, xt, yt,
                      torch.as_tensor(label_probs, dtype=torch.float32))


def make_dataset(seed: int, m: int, n_classes: int = 10,
                 dist: str = "dirichlet", alpha: float = 0.3, c: int = 2,
                 n_train: int = 64, n_test: int = 32, size: int = 8,
                 noise: float = 0.7, device="cpu") -> ClientData:
    rng = _rng(seed)
    if dist == "dirichlet":
        probs = dirichlet_probs(rng, m, n_classes, alpha)
    elif dist == "pathological":
        probs = pathological_probs(rng, m, n_classes, c)
    else:
        raise ValueError(f"dist {dist!r}; known: dirichlet | pathological")
    return make_client_data(rng, probs, n_train, n_test, size=size,
                            noise=noise).to(device)


def sample_batches(generator: torch.Generator, data: ClientData,
                   k_steps: int, batch: int) -> dict:
    """Per-client minibatches for one round: leaves (m, K, B, ...).  The
    indices are drawn on the generator's device (the CPU for a default
    torch.Generator) and gathered on the data's device."""
    m, n = data.y.shape
    idx = torch.randint(0, n, (m, k_steps, batch), generator=generator)
    idx = idx.to(data.y.device)
    rows = torch.arange(m, device=data.y.device)[:, None, None]
    return {"x": data.x[rows, idx], "y": data.y[rows, idx]}


def lm_synthetic_batch(generator: torch.Generator, vocab: int,
                       global_batch: int, seq: int) -> dict:
    """Synthetic LM batch with the reference's Markov rule: a random t0,
    then token_{s} = (token_{s-1} * 31 + u_s) % vocab with u_s uniform in
    [0, 17); t0 itself is not part of the sequence.  labels are tokens
    shifted left by one, wrapping.  Drawn in bulk on the generator's
    device; int64 (B, seq) leaves there.  The draws cannot replay
    `jax.random`."""
    dev = generator.device
    carry = torch.randint(0, vocab, (global_batch,), generator=generator,
                          device=dev)
    noise = torch.randint(0, 17, (seq, global_batch), generator=generator,
                          device=dev)
    tokens = torch.empty((global_batch, seq), dtype=torch.int64, device=dev)
    for s in range(seq):
        carry = torch.remainder(carry * 31 + noise[s], vocab)
        tokens[:, s] = carry
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return {"tokens": tokens, "labels": labels}
