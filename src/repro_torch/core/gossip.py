"""Sparse gossip engine: neighbor-indexed push-pull over a flat buffer.

Port of `repro/core/gossip.py`:

1. `mix_rows(idx, w, x)` — out[i] = sum_j w[i,j] * x[idx[i,j]], summed in
   j order with separate multiply and add ops.
2. `FlatLayout` / `FlatClientState` — the shared leaves of the stacked
   client params live in ONE (m, d_flat) buffer across rounds, packed in
   the reference's wire order (sorted keys: conv1, conv2, dense, gb1, gb2,
   gn1, gn2 for the CNN); the tree form is rebuilt only at the loss / eval
   boundary.
3. `mix_flat` — one push-pull transmission on the resident buffer, and
   `gossip_mix` / `mix_tree`, its tree-form counterparts.  The modes keep
   the reference's meanings:
     "dense"  — the (m, m) contraction in the payload dtype;
     "sparse" — `mix_rows` in the payload dtype.  An f32 payload goes
                through `kernels.ops.gossip_gather` (the CUDA kernel on a
                CUDA buffer), which equals `mix_rows` bit for bit in f32;
     "pallas" — the fused gather that accumulates in f32 and rounds once:
                `kernels.ops.gossip_gather` in every payload dtype.
   mu always mixes through `mix_rows` in f32.
4. the codec branch of `mix_flat` — compressed directed gossip with error
   feedback and reference tracking (`repro_torch.compress`); under
   "pallas" the sparse payloads mix through `kernels.ops.topk_gather`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from .. import tree
from ..compress import feedback
from ..kernels import ops
from . import partition
from .topology import SparseTopology

MODES = ("dense", "sparse", "pallas")


def mix_rows(idx: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w[i,j] * x[idx[i,j]] for stacked x: (m,) or (m, ...).
    Unrolled over the neighbor axis k in j order; w is cast to x's dtype."""
    k = idx.shape[1]
    bshape = (-1,) + (1,) * (x.dim() - 1)

    def term(j):
        return w[:, j].reshape(bshape).to(x.dtype) * x[idx[:, j].long()]

    out = term(0)
    for j in range(1, k):
        out = out + term(j)
    return out


def no_sparsity(P) -> bool:
    """True when a SparseTopology has no sparsity to exploit (k >= m, e.g.
    the fully connected form): every engine entry point densifies then."""
    return isinstance(P, SparseTopology) and P.k >= P.m


def mix_any(P, x: torch.Tensor) -> torch.Tensor:
    """One gossip contraction of stacked per-client values x with either
    topology representation (densified when no_sparsity)."""
    if isinstance(P, SparseTopology) and not no_sparsity(P):
        return mix_rows(P.idx, P.w, x)
    Pd = P.dense() if isinstance(P, SparseTopology) else P
    return torch.einsum("mn,n...->m...", Pd.to(x.dtype), x)


def mix_tree(P, params: dict) -> dict:
    """mix_any over every leaf of a stacked params tree (the per-leaf
    gossip of the tree-form engines)."""
    return tree.tree_map(lambda a: mix_any(P, a), params)


# ---------------------------------------------------------------------------
# flat-buffer layout
# ---------------------------------------------------------------------------
def flat_width(params: dict, mask: dict) -> int:
    """d_flat: total shared parameters per client of stacked params."""
    return sum(math.prod(leaf.shape[1:]) for path, leaf in tree.paths(params)
               if tree.get(mask, path))


def flatten_shared(params: dict, mask: dict, dtype=None) -> torch.Tensor:
    """Ravel the shared leaves of stacked (m, ...) params into one
    (m, d_flat) buffer in wire order (sorted keys).  `dtype` is the wire
    dtype; defaults to the leaves' common dtype."""
    u, _ = partition.split(params, mask)
    leaves = tree.leaves(u)
    m = leaves[0].shape[0]
    dt = dtype if dtype is not None else functools.reduce(
        torch.promote_types, (x.dtype for x in leaves))
    return torch.cat([x.reshape(m, -1).to(dt) for x in leaves], dim=1)


def unflatten_shared(flat: torch.Tensor, params: dict, mask: dict) -> dict:
    """Inverse of flatten_shared: slice the (m, d_flat) buffer back into the
    shared leaves (cast to each leaf's dtype); personal leaves pass through
    from `params` untouched."""
    _, v = partition.split(params, mask)
    return partition.merge(FlatLayout.build(params, mask).unravel(flat), v)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static descriptor of the shared part's wire layout: per shared leaf
    (sorted-key order) its path, unstacked shape, dtype and size."""
    paths: tuple
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    d_flat: int

    @classmethod
    def build(cls, params: dict, mask: dict) -> "FlatLayout":
        """`params` is a stacked (m, ...) tree."""
        u, _ = partition.split(params, mask)
        items = list(tree.paths(u))
        shapes = tuple(tuple(leaf.shape[1:]) for _, leaf in items)
        sizes = tuple(math.prod(s) for s in shapes)
        return cls(tuple(p for p, _ in items), shapes,
                   tuple(leaf.dtype for _, leaf in items), sizes, sum(sizes))

    @property
    def offsets(self) -> tuple:
        out, off = [], 0
        for n in self.sizes:
            out.append(off)
            off += n
        return tuple(out)

    def pack(self, params: dict, mask: dict, dtype=None) -> torch.Tensor:
        """Stacked shared leaves -> (m, d_flat) buffer (wire order)."""
        return flatten_shared(params, mask, dtype=dtype)

    def unravel_row(self, row: torch.Tensor) -> dict:
        """One client's (d_flat,) row -> shared subtree of views (cast to
        each leaf's dtype) — the loss_fn leaf boundary."""
        return tree.from_paths(
            (p, row[off:off + n].reshape(shape).to(dt))
            for p, shape, dt, n, off in zip(self.paths, self.shapes,
                                            self.dtypes, self.sizes,
                                            self.offsets))

    def unravel(self, flat: torch.Tensor) -> dict:
        """(m, d_flat) buffer -> stacked shared subtree."""
        m = flat.shape[0]
        return tree.from_paths(
            (p, flat[:, off:off + n].reshape((m,) + shape).to(dt))
            for p, shape, dt, n, off in zip(self.paths, self.shapes,
                                            self.dtypes, self.sizes,
                                            self.offsets))


class FlatClientState(NamedTuple):
    """Resident representation of the stacked client parameters: the shared
    part in one (m, d_flat) buffer, the personal leaves as a pruned tree."""
    flat: torch.Tensor
    personal: dict

    @classmethod
    def create(cls, params: dict, mask: dict,
               layout: FlatLayout | None = None):
        """-> (state, layout).  Packs the shared part once; an all-personal
        mask yields an empty (m, 0) buffer."""
        layout = layout or FlatLayout.build(params, mask)
        _, v = partition.split(params, mask)
        if layout.d_flat == 0:
            leaf = tree.leaves(params)[0]
            return cls(torch.zeros((leaf.shape[0], 0), dtype=torch.float32,
                                   device=leaf.device), v), layout
        return cls(flatten_shared(params, mask), v), layout

    def to_tree(self, layout: FlatLayout) -> dict:
        """The stacked params tree (eval boundary)."""
        return partition.merge(layout.unravel(self.flat), self.personal)


def _transmit(P, x: torch.Tensor, mu: torch.Tensor, mode: str):
    """The bare push-pull contraction of (x, mu) in the payload's dtype."""
    sparse = isinstance(P, SparseTopology)
    if no_sparsity(P):
        mode = "dense"
    if mode == "dense" or not sparse:
        Pd = P.dense() if sparse else P
        return (torch.einsum("mn,nd->md", Pd.to(x.dtype), x),
                torch.einsum("mn,n->m", Pd, mu))
    if mode == "pallas" or x.dtype == torch.float32:
        mixed = ops.gossip_gather(P.idx, P.w, x)
    else:
        mixed = mix_rows(P.idx, P.w, x)
    return mixed, mix_rows(P.idx, P.w, mu)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"gossip mode {mode!r}; known: {MODES}")


def mix_flat(P, flat: torch.Tensor, mu: torch.Tensor, *,
             mode: str = "sparse", wire_dtype=None, edge_gate=None,
             codec=None, ef=None, ref=None, key=None, codec_gamma=1.0):
    """One push-pull transmission on the resident buffer: flat' = P flat,
    mu' = P mu -> (flat', mu').  A wire_dtype narrows only the payload of
    the mix (the buffer returns in its resident dtype); mu always mixes in
    f32 and is never compressed.

    codec: optional wire codec (`repro_torch.compress`).  The non-self
    edges then ship compressed deltas against each sender's public
    reference copy (`compress.publish` with `ef`/`ref` memory), and the
    self edge keeps the full-fidelity row:

        mixed[i] = P[i,i] * flat[i] + ef[i] + sum_{j != i} P[i,j] * ref'[j]

    and the call returns (mixed, mu', ef', ref').  codec_gamma (a float in
    (0, 1], or a 0-d tensor: the "auto" anneal) runs the codec mix on
    (1-g) I + g P.  An `exact` codec runs the plain body on `flat`.  Under
    mode="pallas" a sparse payload mixes through `kernels.ops.topk_gather`
    and the old references through `kernels.ops.gossip_gather`: a dense
    decode never materializes.  key: what a randomized codec draws from
    (see `compress.codecs`)."""
    _check_mode(mode)
    tensor_gamma = isinstance(codec_gamma, torch.Tensor)
    if (codec is None or codec.exact) and \
            (tensor_gamma or float(codec_gamma) != 1.0):
        raise ValueError(
            f"codec_gamma={codec_gamma} only applies to lossy codecs; "
            f"the exact/uncompressed mix never blends")
    if edge_gate is not None:
        raise NotImplementedError("edge_gate (the async mailbox mix) is "
                                  "ported with the async runtime (ROADMAP "
                                  "queue 1 item 11)")
    if codec is not None:
        if wire_dtype is not None:
            raise ValueError("codec defines the wire format; wire_dtype "
                             "applies to the uncompressed path only")
        if codec.exact:
            mixed, mu2 = _transmit(P, flat, mu, mode)
            return mixed.to(flat.dtype), mu2, ef, ref
        if tensor_gamma:
            g = codec_gamma.to(torch.float32)
        else:
            g = float(codec_gamma)
            if not 0.0 < g <= 1.0:
                raise ValueError(f"codec_gamma must be in (0, 1], got {g}")
        sw = self_weight_of(P)                                # (m,)
        sw_g = (1.0 - g) + g * sw
        payload, ef2, ref2 = feedback.publish(
            codec, ef, ref, flat, key, wire_frac=1.0 - sw_g)
        wire = _mix_wire(P, ref, ref2, payload, mode)
        # the accumulated residual re-enters through the self share (it
        # never rides the wire), so mixed + ef' = flat + ef under
        # column-stochastic weights
        mixed = sw_g[:, None] * flat.to(torch.float32) + ef + g * wire
        mu2 = (1.0 - g) * mu + g * mix_any(P, mu)
        return mixed.to(flat.dtype), mu2, ef2, ref2
    x = flat.to(wire_dtype) if wire_dtype is not None else flat
    mixed, mu2 = _transmit(P, x, mu, mode)
    return mixed.to(flat.dtype), mu2


def self_weight_of(P) -> torch.Tensor:
    """(m,) f32 total weight each row places on itself — the share of a mix
    that never crosses the wire."""
    if isinstance(P, SparseTopology):
        rows = torch.arange(P.m, device=P.idx.device)[:, None]
        return (P.w * (P.idx.long() == rows)).sum(1).to(torch.float32)
    return torch.diagonal(P).to(torch.float32)


def wire_only(P):
    """P with its self edges zeroed — the edges that carry payloads.  Same
    representation in, same out."""
    if isinstance(P, SparseTopology):
        rows = torch.arange(P.m, device=P.idx.device)[:, None]
        return SparseTopology(P.idx, torch.where(P.idx.long() == rows, 0.0,
                                                 P.w))
    eye = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
    return P * (1.0 - eye)


def _mix_wire(P, ref_prev, ref_new, payload, mode: str):
    """sum_{j != i} P[i,j] * ref'[j] in f32 — the tracked half of the codec
    mix.  Under "pallas" with a sparse payload the sum splits linearly,
    P_wire @ ref' = P_wire @ ref + P_wire @ decode(p): the old references
    go through the gossip_gather kernel and the payload through the
    topk_gather kernel, so a dense decode never materializes."""
    Pw = wire_only(P)
    sparse = isinstance(Pw, SparseTopology)
    if sparse and mode == "pallas" and payload.indices is not None \
            and not no_sparsity(Pw):
        d = ref_prev.shape[1]
        return ops.gossip_gather(Pw.idx, Pw.w, ref_prev) \
            + ops.topk_gather(Pw.idx, Pw.w, payload.values.float(),
                              payload.indices, d)
    if sparse and not no_sparsity(Pw) and mode != "dense":
        return mix_rows(Pw.idx, Pw.w, ref_new)
    Pd = Pw.dense() if sparse else Pw
    return torch.einsum("mn,nd->md", Pd.to(torch.float32), ref_new)


def gossip_mix(params: dict, mu: torch.Tensor, P, mask: dict, *,
               mode: str = "sparse", wire_dtype=None):
    """One push-pull transmission of the shared part of a stacked params
    tree, plus the mu update -> (params', mu').  "dense" (or a dense P)
    mixes leaf by leaf; "sparse"/"pallas" flatten the shared leaves in wire
    order, mix the buffer as `mix_flat` does, and slice it back."""
    _check_mode(mode)
    sparse = isinstance(P, SparseTopology)
    if sparse and not any(tree.leaves(mask)):
        # all-personal mask: nothing to mix but mu
        return params, mix_any(P, mu)
    if no_sparsity(P):
        mode = "dense"
    if mode == "dense" or not sparse:
        Pd = P.dense() if sparse else P

        def mix_leaf(a, shared):
            if not shared:
                return a
            x = a.to(wire_dtype) if wire_dtype is not None else a
            return torch.einsum("mn,n...->m...", Pd.to(x.dtype), x
                                ).to(a.dtype)

        return (tree.tree_map(mix_leaf, params, mask),
                torch.einsum("mn,n->m", Pd, mu))
    flat = flatten_shared(params, mask, dtype=wire_dtype)
    mixed, mu2 = _transmit(P, flat, mu, mode)
    return unflatten_shared(mixed, params, mask), mu2
