"""Error-feedback memory and reference tracking for compressed directed
gossip (port of `repro/compress/feedback.py`).

Every client keeps an (m, d_flat) f32 residual `ef` of what its codec
dropped and a public reference copy `ref` of its row that all receivers
agree on.  A crossing (`publish`) ships the compressed DELTA against the
reference:

    x    = rows - ref
    p    = encode(x)
    ref' = ref + decode(p)          (computed as ref + (x - residual))
    ef'  = wire_frac * (x - decode(p))

so receivers mix the dense ref', which tracks the true row, and under
column-stochastic weights the crossing conserves value exactly:
mixed + ef' = rows + ef.  `exact` codecs pass through untouched.
"""
from __future__ import annotations

from typing import Optional

import torch

from .codecs import Payload


def init_ef(codec, flat: torch.Tensor) -> Optional[torch.Tensor]:
    """Zero residual memory shaped like the resident buffer; None for
    exact codecs (nothing is ever dropped)."""
    if codec is None or codec.exact:
        return None
    return torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)


def init_ref(codec, flat: torch.Tensor) -> Optional[torch.Tensor]:
    """Reference copies for lossy codecs, bootstrapped to the initial rows
    (first contact ships one full-fidelity row, which the simulator
    meters); None for exact codecs.  Always a new tensor: `flat.float()`
    of an f32 buffer is the buffer itself, and the sampled round writes
    `flat` in place, so an aliased `ref` would move with it."""
    if codec is None or codec.exact:
        return None
    return flat.to(torch.float32).clone()


def _wire_share(wire_frac: torch.Tensor) -> torch.Tensor:
    return torch.clamp(wire_frac, 0.0, 1.0)[:, None].to(torch.float32)


def encode_with_feedback(codec, ef, rows, key=None, wire_frac=None):
    """-> (payload, ef').  The plain EF-SGD operator: encode rows + ef and
    keep what was dropped.  A building block, not the engines' crossing
    (that is `publish`).  wire_frac: optional (m,) share of each sender's
    mass that rides the wire; the home share keeps its old residual:

        ef' = wire_frac * (x - decode(p)) + (1 - wire_frac) * ef
    """
    if codec.exact:
        return codec.encode(rows, key), ef
    if ef is None:
        raise ValueError(
            f"{type(codec).__name__} is lossy and needs error-feedback "
            f"memory; allocate it with compress.init_ef")
    x = rows.to(torch.float32) + ef
    payload = codec.encode(x, key)
    r = codec.residual(x, payload)
    if wire_frac is None:
        return payload, r
    wf = _wire_share(wire_frac)
    return payload, wf * r + (1.0 - wf) * ef


def publish(codec, ef, ref, rows, key=None, wire_frac=None):
    """One wire crossing with reference tracking -> (payload, ef', ref')
    (see the module docstring).  Exact codecs pass through untouched."""
    if codec.exact:
        return codec.encode(rows, key), ef, ref
    if ef is None or ref is None:
        raise ValueError(
            f"{type(codec).__name__} is lossy and needs error-feedback "
            f"and reference memory; allocate with compress.init_ef / "
            f"compress.init_ref")
    x = rows.to(torch.float32) - ref
    payload = codec.encode(x, key)
    r = codec.residual(x, payload)
    ref2 = ref + (x - r)                       # ref + decode(p), fused
    if wire_frac is None:
        return payload, r, ref2
    return payload, _wire_share(wire_frac) * r, ref2


def decode(codec, payload: Payload, d: int) -> torch.Tensor:
    """Dense decode (receiver side).  The kernel path mixes sparse
    payloads without it (kernels.ops.topk_gather)."""
    return codec.decode(payload, d)
