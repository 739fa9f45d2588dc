"""Gossip mixing through the dense push-sum kernel (port of
`repro/core/kernel_mix.py`).

The whole round's push-pull as one dense (m, m) x (m, d_flat) product on
the CUDA `pushsum_mix` kernel (`kernels.ops.pushsum_mix`), instead of the
neighbor-indexed gather.  Two entry points:

- `make_kernel_mix_flat` — the resident form, for
  `DFedPGP(mix_fn_flat=...)` / `round_fn_flat`: mixes the (m, d_flat)
  buffer directly;
- `make_kernel_mix` — the tree form, for `DFedPGP(mix_fn=...)` /
  `round_fn`: flattens the shared leaves into the (m, d_flat) matrix each
  round, mixes through the flat entry and slices back.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import gossip
from .topology import SparseTopology


def make_kernel_mix_flat(force: str = "auto"):
    """-> mix_fn(flat, mu, rnd, P) for DFedPGP(mix_fn_flat=...).  The DENSE
    path: a SparseTopology P is densified; the buffer mixes in f32 and
    returns in its own dtype, mu mixes by einsum."""

    def mix(flat, mu, rnd, P):
        del rnd
        if isinstance(P, SparseTopology):
            P = P.dense()
        mixed = ops.pushsum_mix(P, flat.to(torch.float32), force=force)
        return mixed.to(flat.dtype), torch.einsum("mn,n->m", P, mu)

    return mix


def make_kernel_mix(mask: dict, force: str = "auto"):
    """-> mix_fn(params, mu, rnd, P) for DFedPGP(mix_fn=...): the tree-form
    wrapper around `make_kernel_mix_flat` (per-round flatten in f32 and
    unflatten)."""
    mix_flat = make_kernel_mix_flat(force)

    def mix(params, mu, rnd, P):
        flat = gossip.flatten_shared(params, mask, dtype=torch.float32)
        mixed, mu2 = mix_flat(flat, mu, rnd, P)
        return gossip.unflatten_shared(mixed, params, mask), mu2

    return mix
