"""Everything a run feeds the program and the reference, made from the
run's `--seed`: weights, client data, the rounds' neighbor tables,
participants and minibatches.

Each draw has a generator of its own, seeded by (seed, stream, index):
any weight leaf, any round's table, participants or batches can be made
again alone, bit for bit on the same device, which is how the reference
gets the same inputs after the program's state is freed.  The traffic
file's numbers choose the sizes; this module is the one generator that
reads them.  The image data follows the pattern of the port's
`data/synthetic.py` (smooth class templates plus noise and a brightness
factor, Dirichlet label shares per client), drawn here on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS, DATA, TABLES, ACTIVE, BATCHES = 1, 2, 3, 4, 5


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed that is a pure function of (seed, *keys); any whole
    seed, however large or negative."""
    entropy = [int(seed) % (1 << 64)] + [int(k) for k in keys]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


def np_rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


def torch_gen(device, seed: int, *keys: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, *keys))
    return g


# ---------------------------------------------------------------------------
# weights: (path, shape of one client, init) -> one stacked (m, ...) leaf
# ---------------------------------------------------------------------------
def leaf(spec: tuple, index: int, m: int, seed: int, device) -> torch.Tensor:
    """Leaf `index` of a model's leaf list for all m clients, f32.  init is
    "ones", "zeros" or ("normal", std)."""
    _, shape, init = spec
    full = (m,) + tuple(shape)
    if init == "ones":
        return torch.ones(full, dtype=torch.float32, device=device)
    if init == "zeros":
        return torch.zeros(full, dtype=torch.float32, device=device)
    kind, std = init
    if kind != "normal":
        raise ValueError(f"init {init!r}")
    g = torch_gen(device, seed, WEIGHTS, index)
    return torch.randn(full, generator=g, device=device).mul_(std)


def leaves(specs: list, m: int, seed: int, device) -> dict:
    """{path: stacked leaf} of every spec, one large draw each."""
    return {spec[0]: leaf(spec, i, m, seed, device)
            for i, spec in enumerate(specs)}


def nest(flat: dict) -> dict:
    """{'a/b': x} -> {'a': {'b': x}}: the program's parameter tree."""
    out: dict = {}
    for path, val in flat.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = val
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of `nest`, over dicts (tuple keys from the program's
    trees joined the same way)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten(val, path))
        else:
            out[path] = val
    return out


# ---------------------------------------------------------------------------
# the round's table and participants (host)
# ---------------------------------------------------------------------------
def directed_table(seed: int, r: int, m: int, n: int):
    """Round r's pull table: every client takes n distinct uniform random
    in-neighbors besides itself, self first, weights 1/(n+1).  ->
    (idx (m, n+1) int32, w (m, n+1) float32) numpy arrays."""
    n = min(n, m - 1)
    rng = np_rng(seed, TABLES, r)
    rows = np.arange(m)[:, None]
    draws = rng.random((m, m - 1)).argsort(axis=1)[:, :n]
    nb = np.where(draws >= rows, draws + 1, draws)
    idx = np.concatenate([rows, nb], axis=1).astype(np.int32)
    w = np.full((m, n + 1), 1.0 / (n + 1), dtype=np.float32)
    return idx, w


def active_ids(seed: int, r: int, m: int, frac: float):
    """Round r's participants: sorted int32 ids of a uniform subset of
    max(1, round(frac m)) clients, or None for full participation."""
    if frac >= 1.0:
        return None
    k = max(1, int(round(frac * m)))
    ids = np_rng(seed, ACTIVE, r).choice(m, size=k, replace=False)
    return np.sort(ids).astype(np.int32)


# ---------------------------------------------------------------------------
# client data and minibatches (device)
# ---------------------------------------------------------------------------
def image_data(seed: int, m: int, n: int, size: int, channels: int,
               n_classes: int, alpha: float, noise: float, device):
    """m clients' training images, (m, n, size, size, channels) f32 NHWC,
    and labels (m, n) int64: Dirichlet(alpha) label shares per client,
    each image its class template plus `noise` x N(0, 1), times a
    brightness in [0.8, 1.2)."""
    rng = np_rng(seed, DATA)
    probs = rng.dirichlet(np.full((n_classes,), alpha), size=m)
    coarse = torch.as_tensor(rng.standard_normal(
        (n_classes, channels, size // 2, size // 2)), dtype=torch.float32)
    templ = F.interpolate(coarse, size=(size, size), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1) * 1.5
    templ = templ.to(device)
    cum = torch.as_tensor(np.cumsum(probs, axis=1), dtype=torch.float32,
                          device=device)
    g = torch_gen(device, seed, DATA)
    u = torch.rand((m, n, 1), generator=g, device=device)
    y = torch.clamp((u > cum[:, None, :]).sum(-1), max=n_classes - 1)
    x = templ[y]
    x.add_(torch.randn(x.shape, generator=g, device=device), alpha=noise)
    x.mul_(0.8 + 0.4 * torch.rand((m, n, 1, 1, 1), generator=g,
                                  device=device))
    return x, y


def minibatch_rows(seed: int, r: int, rows: int, n: int, steps: int,
                   batch: int, device) -> torch.Tensor:
    """Round r's sample indices for `rows` clients: (rows, steps, batch)
    int64 into each client's n examples, all distinct within a client's
    round (a random permutation's first steps x batch)."""
    if steps * batch > n:
        raise ValueError(f"{steps} steps x {batch} rows > {n} examples")
    g = torch_gen(device, seed, BATCHES, r)
    order = torch.rand((rows, n), generator=g, device=device).argsort(dim=1)
    return order[:, :steps * batch].reshape(rows, steps, batch)


def token_batches(seed: int, r: int, rows: int, steps: int, batch: int,
                  seq: int, vocab: int, device) -> dict:
    """Round r's token rows for `rows` clients: tokens (rows, steps, batch,
    seq) uniform over the vocabulary, labels the next token."""
    g = torch_gen(device, seed, BATCHES, r)
    t = torch.randint(0, vocab, (rows, steps, batch, seq + 1), generator=g,
                      device=device)
    return {"tokens": t[..., :-1].contiguous(),
            "labels": t[..., 1:].contiguous()}


def split_steps(b: dict, k_v: int) -> dict:
    """(n, K, ...) leaves -> {'v': the first k_v steps, 'u': the rest}."""
    return {"v": {k: a[:, :k_v] for k, a in b.items()},
            "u": {k: a[:, k_v:] for k, a in b.items()}}


def lecun(fan_in: int) -> tuple:
    return ("normal", 1.0 / math.sqrt(fan_in))
