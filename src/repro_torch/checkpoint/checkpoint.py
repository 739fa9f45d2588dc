"""Pytree checkpointing: an npz with path-flattened keys (port of
`repro/checkpoint/checkpoint.py`).

A state is a nested structure of dicts, NamedTuples, lists and tuples
whose leaves are tensors, numpy arrays or Python scalars.  Each leaf is
stored under the key the reference builds from its jax tree path: dict
keys (sorted), NamedTuple field names and sequence indices joined by "/"
(e.g. `opt_u/momentum`, `mail/slots_flat`).  None leaves write no key, so
`ef=None` writes nothing and the port's pruned personal trees give the
reference's keys.  Either package therefore loads the other's files.

- bf16 is stored as its uint16 bits (npz has no bf16): `view(torch.int16)`
  then numpy `view(np.uint16)`, and back through the template's dtype.
- A Python int leaf (the async clock's tick) is written as a 0-d int32,
  the reference's dtype, and given back as an int.
- Restore takes a template of the same structure (any values): each leaf
  comes back in the template's kind, dtype and device, so no pickle is
  involved.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node, prefix: tuple = ()):
    """(key, leaf) pairs in the reference's tree order; None leaves are
    skipped."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _items(node[k], prefix + (str(k),))
    elif _is_namedtuple(node):
        for name, v in zip(node._fields, node):
            yield from _items(v, prefix + (name,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), node


def _rebuild(node, fn, prefix: tuple = ()):
    """The template's structure with each leaf replaced by fn(key, leaf)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(v, fn, prefix + (name,))
                            for name, v in zip(node._fields, node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(node))
    return fn("/".join(prefix), node)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _bf16_from_bits(raw: np.ndarray) -> torch.Tensor:
    bits = np.ascontiguousarray(raw).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _from_numpy(key: str, raw: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        if raw.dtype.kind == "V" or (leaf.dtype == torch.bfloat16
                                     and raw.dtype == np.uint16):
            t = _bf16_from_bits(raw)     # bf16 bits (legacy: void bits)
        else:
            t = torch.from_numpy(np.array(raw, copy=True))
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, bool):
        return bool(raw)
    if isinstance(leaf, int):
        return int(raw)
    if isinstance(leaf, float):
        return float(raw)
    out = np.array(raw, copy=True)
    if out.shape != np.shape(leaf):
        raise ValueError(f"{key}: {out.shape} != {np.shape(leaf)}")
    return out.astype(np.asarray(leaf).dtype)


def _zero(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.zeros_like(leaf)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(0)
    return np.zeros_like(leaf)


def zeros_like(tree: Any) -> Any:
    """The tree with every leaf zeroed in its own kind, dtype and device —
    a restore template whose every value must come from the file."""
    return _rebuild(tree, lambda key, leaf: _zero(leaf))


def flatten(tree: Any) -> dict:
    """{key: numpy array} — what `save_pytree` writes."""
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def save_pytree(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten(tree))
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def load_pytree(path: str, template: Any) -> Any:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return _rebuild(template, lambda key, leaf: _from_numpy(
            key, data[key], leaf))


def save_train_state(ckpt_dir: str, step: int, state: Any,
                     keep: int = 3) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    save_pytree(path, state, metadata={"step": step})
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".npz"))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
        meta = os.path.join(ckpt_dir, old[:-4] + ".meta.json")
        if os.path.exists(meta):
            os.remove(meta)
    return path


def restore_train_state(ckpt_dir: str, template: Any):
    """-> (state, step) of the latest `step_*.npz` in ckpt_dir, or
    (None, 0) when there is none."""
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".npz"))
    if not ckpts:
        return None, 0
    latest = ckpts[-1]
    step = int(latest[len("step_"):-len(".npz")])
    return load_pytree(os.path.join(ckpt_dir, latest), template), step
