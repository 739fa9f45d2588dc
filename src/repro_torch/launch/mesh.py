"""Meshes and the client layout (port of `repro/launch/mesh.py`).

The reference lays clients over a jax device mesh.  The port has two
kinds of mesh object, both read as a jax `Mesh` is (`.axis_names`,
`.shape[name]`), so `client_layout`, `steps.decide_layout` and
`sharding.py` run on either:
- `MeshSpec`, a description (axis names and sizes): the production meshes
  of `make_production_mesh`, which nothing runs on yet (the dry run reads
  them, `launch/dryrun.py`);
- `ClientMesh`, the client mesh over the ranks of the initialized default
  process group (`make_host_mesh`): 'data' has W ranks, each holding a
  contiguous block of the m clients, and 'model' has 1.
`one_device_layout` is the layout a single device runs (`launch/train.py`
without `--ranks`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from . import ranks


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


class ClientMesh(NamedTuple):
    """A client mesh over the W ranks of the default process group, laid
    out as `jax.make_mesh((W / T, T), ("data", "model"))` lays out devices:
    global rank = d * T + t.  This process is `rank`, on `device`, at data
    index d (`data_index`) and model index t (`model_index`); it holds the
    clients `rows` of `n_clients` (the block of d) and the t-th shard of
    each of their models.  `data_group` holds the ranks of its model index
    (the mixes run there), `model_group` the ranks of its data index (the
    tensor-parallel collectives run there)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    n_clients: int
    rank: int
    device: torch.device
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any

    @property
    def world(self) -> int:
        """The ranks of the data group: how many blocks the clients are
        cut into."""
        return self.shape["data"]

    @property
    def rows(self) -> Tuple[int, int]:
        return ranks.row_range(self.n_clients, self.world, self.data_index)

    @property
    def n_local(self) -> int:
        return self.n_clients // self.world

    def peer(self, q: int) -> int:
        """The global rank of data index q in this rank's data group."""
        return q * self.shape["model"] + self.model_index


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The description of the single-pod (data 16, model 16) or multi-pod
    (pod 2, data 16, model 16) mesh.  Nothing runs on it: the dry run
    places the production steps on it."""
    if multi_pod:
        return mesh_spec((2, 16, 16), ("pod", "data", "model"))
    return mesh_spec((16, 16), ("data", "model"))


def make_host_mesh(n_clients: int = 4, model: int = 1) -> ClientMesh:
    """The client mesh of `n_clients` over the W ranks of the initialized
    default process group (`ranks.init`): (data W / T, model T) with T =
    `model`.  Refuses W % T != 0 and m % (W / T) != 0.  Every rank creates
    every data group and every model group, in the same order (a rank
    that skipped one would hang the others)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs the default process group: "
                           "call launch.ranks.init first")
    world, rank = dist.get_world_size(), dist.get_rank()
    T = int(model)
    if T < 1 or world % T:
        raise ValueError(f"{world} ranks over model={T}: the client mesh "
                         f"wants W % T == 0 (whole data indices)")
    n_data = world // T
    d, t = divmod(rank, T)
    ranks.row_range(n_clients, n_data, d)          # refuses m % (W / T)
    data_groups = [dist.new_group([q * T + s for q in range(n_data)])
                   for s in range(T)]
    model_groups = [dist.new_group([q * T + s for s in range(T)])
                    for q in range(n_data)]
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device())
              if backend == "nccl" else torch.device("cpu"))
    return ClientMesh(("data", "model"), {"data": n_data, "model": T},
                      int(n_clients), rank, device, d, t, data_groups[t],
                      model_groups[d])


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
    """The layout of `launch/train.py` on one device, and of every rank of
    a client mesh: clients named along 'data', TP along 'model' (a client
    mesh's model group executes it, `launch/tp.py`); n_clients counts
    every client of the run."""
    from .steps import Layout
    return Layout(("data",), (), ("model",), (), int(n_clients),
                  int(per_client_batch))
