"""Sharding rules: parameter-path patterns -> placements (port of
`repro/launch/sharding.py`).

A placement is a plain tuple in `PartitionSpec` order: per dim an axis
name, a tuple of names, or None (replicated); `()` replicates the whole
leaf.  There is no jax `NamedSharding`: the functions are arithmetic on
shapes and a mesh description (`mesh.MeshSpec`, or anything with
`.axis_names` and `.shape[name]`), read by the step builders
(`steps.params_shardings` and its kin) and by the dry run
(`launch/dryrun.py`), which turns them into bytes per device.

Rules are written against the *logical* trailing dims of each leaf; any
extra leading dims (the stacked-layer axis, the stacked-client axis) are
padded with None / the client axes.  `TP` is resolved to the
tensor-parallel mesh axes (('model',) normally; ('data', 'model') for the
pod_clients strategy on the multi-pod mesh).  A divisibility check
demotes TP to replication (trying the other dims first) so odd
vocabularies (whisper 51,866, granite 49,155) still place.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

from ..tree import paths, tree_map, from_paths

TP = "__TP__"

# (regex on the path, logical trailing spec).  First match wins.
RULES: Tuple[Tuple[str, Tuple], ...] = (
    # --- MoE routed experts: expert-parallel over TP ---
    (r"moe/w[gud]$",               (TP, None, None)),
    (r"moe/router$",               (None, None)),
    (r"(shared|mlp)/w[gu]$",       (None, TP)),
    (r"(shared|mlp)/wd$",          (TP, None)),
    # --- MLA ---
    (r"attn/wq_a$",                (None, TP)),
    (r"attn/wq_b$",                (None, TP, None)),
    (r"attn/wkv_a$",               (None, None)),
    (r"attn/wkv_b$",               (None, TP, None)),
    # --- attention (GQA / cross / self) ---
    (r"attn/w[qkv]$",              (None, TP)),
    (r"attn/wo$",                  (TP, None)),
    (r"attn/b[qkv]$",              (TP,)),
    # --- dense MLPs ---
    (r"mlp/w1$",                   (None, TP)),
    (r"mlp/w2$",                   (TP, None)),
    (r"mlp/b1$",                   (TP,)),
    (r"mlp/b2$",                   (None,)),
    # --- RG-LRU / Griffin ---
    (r"rec/w_in_[xy]$",            (None, TP)),
    (r"rec/w_[ai]$",               (None, TP)),
    (r"rec/w_out$",                (TP, None)),
    (r"rec/(b_[ai]|lam)$",         (TP,)),
    (r"rec/conv_w$",               (None, TP)),
    # --- xLSTM ---
    (r"w_up$",                     (None, TP)),
    (r"w_down$",                   (TP, None)),
    (r"w_gates$",                  (None, TP)),
    (r"r_gates$",                  (TP, None, None)),
    (r"(^|/)w[qkv]$",              (None, TP)),
    (r"w_if$",                     (None, None)),
    (r"conv_w$",                   (None, TP)),
    (r"(^|/)gn$",                  (TP,)),
    (r"b_if$",                     (None,)),
    (r"b_gates$",                  (TP,)),
    # --- embeddings / heads ---
    (r"^embed$",                   (TP, None)),
    (r"^lm_head$",                 (None, TP)),
    # --- CNN (FL sim model) ---
    (r"features/conv\d$",          (None, None, None, TP)),
    (r"features/dense$",           (None, TP)),
    (r"classifier/w$",             (None, None)),
)


def axes_size(mesh, axes) -> int:
    """The number of devices along `axes` (None, a name or names)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def axes_or_none(axes):
    """() -> None, (a,) -> a, (a, b) -> (a, b): a placement entry."""
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _resolve(spec: Tuple, shape: Tuple[int, ...], tp, tp_size: int) -> Tuple:
    """Substitute TP, enforcing divisibility; try to relocate TP if needed."""
    out = list(spec)
    tp_pos = [i for i, s in enumerate(out) if s == TP]
    if not tp_pos:
        return tuple(out)
    i = tp_pos[0]
    if shape[i] % tp_size == 0:
        out[i] = tp
        return tuple(out)
    # preferred dim not divisible: try the other dims (largest first)
    out[i] = None
    cands = sorted((d for d in range(len(shape)) if d != i and out[d] is None),
                   key=lambda d: -shape[d])
    for d in cands:
        if shape[d] % tp_size == 0:
            out[d] = tp
            break
    return tuple(out)


def _add_fsdp(resolved: Tuple, shape: Tuple[int, ...], fsdp_axes,
              fsdp_size: int) -> Tuple:
    """Place the FSDP axes on the largest still-unsharded divisible dim
    (weight sharding over the data axis: deepseek-v2-236b's clients and
    long_500k decode)."""
    if not fsdp_axes or fsdp_size <= 1:
        return resolved
    fs = axes_or_none(tuple(fsdp_axes))
    out = list(resolved)
    cands = sorted((d for d in range(len(shape)) if out[d] is None),
                   key=lambda d: -shape[d])
    for d in cands:
        if shape[d] % fsdp_size == 0 and shape[d] >= fsdp_size:
            out[d] = fs
            break
    return tuple(out)


def spec_for_path(path: str, shape: Tuple[int, ...], tp_axes: Sequence[str],
                  tp_size: int, n_stack_extra: int = 0,
                  fsdp_axes: Sequence[str] = (), fsdp_size: int = 1) -> Tuple:
    """The placement of a single-model leaf (no client axis).  Leading
    stacked dims beyond what the rule covers are replicated (layer
    stacks); n_stack_extra is the reference's unused knob."""
    tp = axes_or_none(tuple(tp_axes))
    for pat, spec in RULES:
        if re.search(pat, path):
            lead = len(shape) - len(spec)
            if lead < 0:      # leaf smaller than its rule
                return ()
            resolved = _resolve(spec, shape[lead:], tp, tp_size)
            resolved = _add_fsdp(resolved, shape[lead:], fsdp_axes, fsdp_size)
            return (None,) * lead + resolved
    # replicate by default (norms, scalars, biases), but big unmatched
    # leaves still get FSDP so nothing large is ever fully replicated;
    # never shard dim 0 of a multi-dim leaf (it may be a layer stack)
    if fsdp_axes and fsdp_size > 1 and len(shape) >= 1:
        if len(shape) == 1:
            return _add_fsdp((None,), shape, fsdp_axes, fsdp_size)
        return (None,) + _add_fsdp((None,) * (len(shape) - 1), shape[1:],
                                   fsdp_axes, fsdp_size)
    return ()


def path_str(path: tuple) -> str:
    """A tree path as the rules read it: keys and list indices joined by
    '/' (the reference's key path string)."""
    return "/".join(str(k) for k in path)


def params_sharding(params_tree, mesh, tp_axes: Sequence[str],
                    client_axes: Optional[Sequence[str]] = None,
                    fsdp_axes: Sequence[str] = ()):
    """The placement of every leaf of a (possibly client-stacked) tree, a
    tree of the same structure.  client_axes: every leaf's FIRST dim is the
    stacked-client dim, placed over those axes; fsdp_axes: every weight
    also over these (its largest free divisible dim)."""
    tp_size = axes_size(mesh, tuple(tp_axes))
    fsdp_size = axes_size(mesh, tuple(fsdp_axes)) if fsdp_axes else 1
    ca = axes_or_none(tuple(client_axes)) if client_axes else None
    out = []
    for path, leaf in paths(params_tree):
        shape = tuple(leaf.shape)
        if client_axes:
            inner = spec_for_path(path_str(path), shape[1:], tp_axes, tp_size,
                                  fsdp_axes=fsdp_axes, fsdp_size=fsdp_size)
            spec = (ca,) + inner
        else:
            spec = spec_for_path(path_str(path), shape, tp_axes, tp_size,
                                 fsdp_axes=fsdp_axes, fsdp_size=fsdp_size)
        out.append((path, spec))
    return from_paths(out)


def _flat_axis(mesh, tp_axes, d_flat: int):
    """The flat dim's placement: over the TP axes when it divides evenly."""
    tp_size = axes_size(mesh, tuple(tp_axes)) if tp_axes else 1
    if tp_axes and tp_size > 1 and d_flat > 0 and d_flat % tp_size == 0:
        return axes_or_none(tuple(tp_axes))
    return None


def flat_buffer_spec(mesh, client_axes: Sequence[str], d_flat: int,
                     tp_axes: Sequence[str] = ()) -> Tuple:
    """The placement of the resident (m, d_flat) shared buffer and every
    array of its layout (the (m, d_flat) momentum, the codec's ef / ref):
    rows over the client axes, the flat dim over the TP axes when it
    divides evenly (it concatenates whole leaves, so a TP shard cuts
    through leaves: fine for the mix, a pure row operation)."""
    ca = axes_or_none(tuple(client_axes)) if client_axes else None
    return (ca, _flat_axis(mesh, tp_axes, d_flat))


def sampled_buffer_spec(mesh, client_axes: Sequence[str], n_active: int,
                        d_flat: int, tp_axes: Sequence[str] = ()) -> Tuple:
    """The placement of the compact (n_active, d_flat) sampled working
    set and everything of its layout: rows over the client axes only when
    n_active divides their size evenly (else replicated rows, the compact
    set being small by construction); the flat dim as the resident
    buffer's."""
    ca = None
    if client_axes:
        c_size = axes_size(mesh, tuple(client_axes))
        if c_size > 1 and n_active % c_size == 0:
            ca = axes_or_none(tuple(client_axes))
    return (ca, _flat_axis(mesh, tp_axes, d_flat))


def batch_sharding(batch_tree, mesh, batch_axes: Sequence[str]):
    """The leading (client or batch) dim of every leaf over batch_axes."""
    ba = axes_or_none(tuple(batch_axes))
    return tree_map(lambda leaf: (ba,) + (None,) * (leaf.dim() - 1),
                    batch_tree)


def replicated(tree, mesh):
    return tree_map(lambda _: (), tree)


def cache_sharding(cache_tree, mesh, batch_axes: Sequence[str],
                   tp_axes: Sequence[str]):
    """KV caches / recurrent state: the first dim (of the first two) whose
    size divides by the batch axes goes over them, the last dims (one of
    the last two) over TP when divisible."""
    tp_size = axes_size(mesh, tuple(tp_axes))
    ba = axes_or_none(tuple(batch_axes))
    ba_size = axes_size(mesh, tuple(batch_axes))
    tp = axes_or_none(tuple(tp_axes))

    def spec(leaf):
        shape = tuple(leaf.shape)
        dims = [None] * len(shape)
        for i, s in enumerate(shape):
            if s % ba_size == 0 and s > 1 and i <= 1:
                dims[i] = ba
                break
        for i in range(len(shape) - 1, max(len(shape) - 3, 0), -1):
            if dims[i] is None and shape[i] % tp_size == 0 \
                    and shape[i] >= tp_size:
                dims[i] = tp
                break
        return tuple(dims)

    return tree_map(spec, cache_tree)


def shards(spec: Tuple, mesh) -> int:
    """How many pieces a placement cuts a leaf into: the product of the
    mesh sizes of every axis it names."""
    n = 1
    for entry in spec:
        if entry is None:
            continue
        n *= axes_size(mesh, entry)
    return n
