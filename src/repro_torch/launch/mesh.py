"""Mesh descriptions and the client layout (port of
`repro/launch/mesh.py`).

The reference lays clients over a jax device mesh.  The port has no mesh
object yet: `MeshSpec` carries what the layout functions read of one (its
axis names and sizes), so `client_layout` and `steps.decide_layout` run on
the production meshes' descriptions; `one_device_layout` is the layout a
single card runs (`launch/train.py`).  Building meshes over real devices
(`make_production_mesh`, `make_host_mesh`) comes with the multi-rank
mixes, ROADMAP item 14b.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class MeshSpec(NamedTuple):
    """A mesh's axis names and sizes, read as a jax `Mesh` is
    (`.axis_names`, `.shape[name]`)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def mesh_spec(shape, axes) -> MeshSpec:
    """(sizes, names) -> MeshSpec, the arguments of `jax.make_mesh`."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh sizes {shape} and axes {axes}: want one "
                         f"size per distinct axis name")
    return MeshSpec(axes, dict(zip(axes, shape)))


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} builds a mesh over real devices for the shard_map / "
        f"ppermute mixes, which are not ported yet (ROADMAP item 14b); "
        f"one card runs every client on one device "
        f"(mesh.one_device_layout)")


def make_production_mesh(*, multi_pod: bool = False):
    _not_ported("make_production_mesh")


def make_host_mesh(n_clients: int = 4, model: int = 2):
    _not_ported("make_host_mesh")


def client_layout(mesh, strategy: str = "auto", arch_id: str = ""):
    """-> (client_axes, tp_axes, n_clients).

    'data_clients': clients along data (and pod, if present), the
        default: single-pod 16 clients, multi-pod 32, TP = model (16).
    'pod_clients': clients along pod only; TP spans (data, model) = 256,
        for deepseek-v2-236b, whose per-client shards do not fit one
        16-chip row."""
    axes = mesh.axis_names
    multi_pod = "pod" in axes
    if strategy == "auto":
        strategy = ("pod_clients" if multi_pod
                    and arch_id == "deepseek-v2-236b" else "data_clients")
    if strategy == "pod_clients":
        if not multi_pod:
            raise ValueError("pod_clients needs the multi-pod mesh")
        return ("pod",), ("data", "model"), mesh.shape["pod"]
    client_axes = ("pod", "data") if multi_pod else ("data",)
    n_clients = 1
    for a in client_axes:
        n_clients *= mesh.shape[a]
    return client_axes, ("model",), n_clients


def one_device_layout(n_clients: int, per_client_batch: int):
    """The layout of `launch/train.py` on one device: every client on it,
    clients named along 'data', no tensor parallelism to speak of."""
    from .steps import Layout
    return Layout(("data",), (), ("model",), (), int(n_clients),
                  int(per_client_batch))
