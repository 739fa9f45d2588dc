"""Step constructors and input structs of Regime B (port of
`repro/launch/steps.py`).

Regime B: each client of the paper's decentralized directed gossip holds
its own personalized transformer LM.  The client axis is a real leading
axis of every parameter; the push-sum gossip of the shared part `u` is
the mixing-matrix contraction over the run's `TopologySchedule` (on the
resident (m, d_flat) buffer, the `gossip_gather` kernel on the card) or
the one-peer permutation mix of the reference's `shard_map` + `ppermute`.

One device holds every client (`mesh` None).  A client mesh
(`mesh.make_host_mesh`) spreads them over the (data, model) ranks of a
`torch.distributed` group: each data index holds a contiguous block of
rows, and its T model ranks split those clients' models (tensor
parallelism, executed by `launch/tp.py`: each rank holds its shard of
every leaf, or its columns of the resident buffer).  The permutation mix
(`make_ppermute_mix_flat`, `make_ppermute_mix`) and the matrix mix
(`make_matrix_mix_flat`, and `make_matrix_mix_sampled` for a sampled
round's compact set) exchange the rows that cross data indices with
point-to-point operations among the ranks of one model index (its data
group; `launch/ranks.py` plans them), each mixing its own shard; a
`RankRound` reduces the rounds' metrics and gauges over the mesh.
The placements of the reference's `NamedSharding`s are tuples of
`launch/sharding.py`, derived from any mesh object (a `MeshSpec` of the
production meshes included); with `mesh` None the `build_*_step` tuples
hold None.  Where the reference builds `jax.ShapeDtypeStruct`s, the port
builds tensors on the "meta" device (shapes and dtypes, no data).

Layouts (from the reference):
- ``data_clients`` (default): clients over ('pod', 'data'); TP 'model'.
- ``fsdp``: one client FSDP-sharded over 'data' and TP-sharded over
  'model', for deepseek-v2-236b (one pod per client on the multi-pod
  mesh) and for long_500k decode (global batch 1 cannot feed 16 clients).
On a client mesh the ranks of a model group execute the TP placement of
every family (`launch/tp.py`).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import torch

from ..configs import InputShape
from ..core import dfedpgp, gossip, partition, topology
from ..core.gossip import FlatLayout
from ..kernels import ops
from ..models import get_model, prefill_logits
from ..models.config import ModelConfig
from ..obs import gauges as obs_gauges
from ..obs import graph as obs_graph
from ..optim import SGD, SGDState
from ..tree import from_paths, paths, tree_map
from ..tree import get as tree_get
from . import ranks, sharding, tp
from .mesh import ClientMesh
from .sharding import axes_or_none

META = torch.device("meta")


class Layout(NamedTuple):
    client_axes: Tuple[str, ...]   # stacked-client dim of every leaf
    batch_axes: Tuple[str, ...]    # within-client batch dim (fsdp layout)
    tp_axes: Tuple[str, ...]
    fsdp_axes: Tuple[str, ...]
    n_clients: int
    per_client_batch: int


# archs whose per-client parameters exceed one 16-chip TP row
FSDP_ARCHS = ("deepseek-v2-236b",)


def decide_layout(mesh, arch_id: str, shape: InputShape) -> Layout:
    """The client layout of `shape` on `mesh` (anything with
    `.axis_names` and `.shape[name]`: a `mesh.MeshSpec`)."""
    axes = mesh.axis_names
    multi_pod = "pod" in axes

    def nsize(axs):
        n = 1
        for a in axs:
            n *= mesh.shape[a]
        return n

    if arch_id in FSDP_ARCHS:
        ca = ("pod",) if multi_pod else ()
        m = nsize(ca) if ca else 1
        return Layout(ca, ("data",), ("model",), ("data",), m,
                      shape.global_batch // m)

    client_axes = ("pod", "data") if multi_pod else ("data",)
    m = nsize(client_axes)
    if shape.global_batch < m:
        # long_500k (B=1): one model, weights FSDP over the idle data axis
        fa = ("pod", "data") if multi_pod else ("data",)
        return Layout((), (), ("model",), fa, 1, shape.global_batch)
    return Layout(client_axes, (), ("model",), (), m, shape.global_batch // m)


# ---------------------------------------------------------------------------
# input structs (meta tensors: never allocated)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, shape: InputShape,
                 lead: Tuple[int, ...]) -> dict:
    """One model-input batch with leading dims `lead` (e.g. (m, K, B)):
    tokens and labels (..., seq_len) int64 (the reference's int32; torch
    indexes an embedding with int64).  seq_len is the TOTAL context: for
    the vlm family the vision embeddings (..., n_vision_tokens, d_model)
    f32 take its first n_vision_tokens positions and the text the rest;
    for the encdec family the (stub) conv frontend supplies the frame
    embeddings (..., n_frames, d_model) f32 and seq_len is the decoder
    length."""
    get_model(cfg)        # raises for an unknown family
    lead = tuple(lead)
    S = shape.seq_len
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        return {"tokens": _meta(lead + (S - nv,), torch.int64),
                "vision": _meta(lead + (nv, cfg.d_model), torch.float32),
                "labels": _meta(lead + (S - nv,), torch.int64)}
    if cfg.family == "encdec":
        return {"frames": _meta(lead + (cfg.n_frames, cfg.d_model),
                                torch.float32),
                "tokens": _meta(lead + (S,), torch.int64),
                "labels": _meta(lead + (S,), torch.int64)}
    return {"tokens": _meta(lead + (S,), torch.int64),
            "labels": _meta(lead + (S,), torch.int64)}


def stacked_param_struct(cfg: ModelConfig, m: int) -> dict:
    """The (m, ...)-stacked parameter tree of `m` clients as meta tensors:
    one client's init traced under FakeTensorMode (no memory), the client
    axis put in front."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    api = get_model(cfg)
    with FakeTensorMode():
        one = api.init_params(torch.Generator(), cfg, device="cpu")
        shapes = [(p, tuple(a.shape), a.dtype) for p, a in paths(one)]
    return from_paths((p, _meta((m,) + shape, dt)) for p, shape, dt in shapes)


def input_specs(cfg: ModelConfig, shape: InputShape, layout: Layout,
                k_u: int = 1, k_v: int = 1) -> dict:
    """Meta tensors for the step function's data arguments."""
    m, B = layout.n_clients, layout.per_client_batch
    if shape.kind == "train":
        return {
            "batches": {"v": batch_struct(cfg, shape, (m, k_v, B)),
                        "u": batch_struct(cfg, shape, (m, k_u, B))},
            "P": _meta((m, m), torch.float32),
        }
    if shape.kind == "prefill":
        b = batch_struct(cfg, shape, (m, B))
        b.pop("labels")
        return {"batch": b}
    # decode: one new token against a seq_len-deep cache / recurrent state
    api = get_model(cfg)
    cache = api.init_cache(cfg, B, shape.seq_len, device=META)
    cache = tree_map(lambda x: _meta((m,) + tuple(x.shape), x.dtype), cache)
    return {"cache": cache, "tokens": _meta((m, B, 1), torch.int64),
            "pos": _meta((), torch.int32)}


# ---------------------------------------------------------------------------
# shardings (placements as `sharding.py` tuples)
# ---------------------------------------------------------------------------
def batch_specs(batch_tree, mesh, layout: Layout, n_lead: int):
    """Client dim (0) over client_axes; per-client batch dim (n_lead) over
    batch_axes; everything else replicated."""
    ca = axes_or_none(layout.client_axes)
    ba = axes_or_none(layout.batch_axes)

    def spec(leaf):
        dims = [None] * leaf.dim()
        if ca is not None and leaf.dim():
            dims[0] = ca
        if ba is not None and leaf.dim() > n_lead:
            dims[n_lead] = ba
        return tuple(dims)

    if isinstance(batch_tree, torch.Tensor):
        return spec(batch_tree)
    return tree_map(spec, batch_tree)


def params_shardings(params_struct, mesh, layout: Layout):
    return sharding.params_sharding(
        params_struct, mesh, layout.tp_axes,
        client_axes=layout.client_axes or None,
        fsdp_axes=layout.fsdp_axes)


def _client_spec(layout: Layout) -> tuple:
    ca = axes_or_none(layout.client_axes)
    return (ca,) if ca is not None else ()


def state_shardings(state_struct, mesh, layout: Layout):
    """Placements of a DFedPGPState with client-stacked params / momentum
    trees: full-momentum leaves share their param's, the (m,) scalar
    placeholders ride the client axes."""
    ps = params_shardings(state_struct.params, mesh, layout)

    def one(path, leaf):
        if leaf.dim() <= 1:
            return _client_spec(layout) if leaf.dim() == 1 else ()
        return tree_get(ps, path)

    def opt(mom_struct):
        return SGDState(from_paths((p, one(p, leaf))
                                   for p, leaf in paths(mom_struct.momentum)))

    return dfedpgp.DFedPGPState(params=ps, mu=_client_spec(layout),
                                opt_u=opt(state_struct.opt_u),
                                opt_v=opt(state_struct.opt_v), round=())


def flat_state_shardings(state_struct, mesh, layout: Layout):
    """Placements of a FlatDFedPGPState: the (m, d_flat) buffer rows over
    the client axes and the flat dim over TP (`sharding.flat_buffer_spec`),
    shared by its momentum and the codec's ef / ref; the personal leaves
    and their momentum by the per-leaf rules; mu over the client axes."""
    buf = sharding.flat_buffer_spec(mesh, layout.client_axes,
                                    state_struct.flat.shape[1],
                                    layout.tp_axes)
    personal = params_shardings(state_struct.personal, mesh, layout)
    return dfedpgp.FlatDFedPGPState(
        flat=buf, personal=personal, mu=_client_spec(layout),
        opt_u=SGDState(buf), opt_v=SGDState(personal), round=(),
        ef=None if state_struct.ef is None else buf,
        ref=None if state_struct.ref is None else buf)


def cache_shardings(cache_struct, mesh, layout: Layout):
    """KV caches / recurrent state (client, [layer stack,] batch, ...):
    the client dim over the client axes, the first of dims 1-2 that
    divides over the batch axes, the last dim (down to dim 2) that divides
    over TP."""
    ca = axes_or_none(layout.client_axes)
    ba = axes_or_none(layout.batch_axes)
    tp = axes_or_none(layout.tp_axes)
    tp_size = sharding.axes_size(mesh, layout.tp_axes)
    ba_size = sharding.axes_size(mesh, layout.batch_axes)

    def spec(leaf):
        shape = tuple(leaf.shape)
        dims = [None] * len(shape)
        if ca is not None:
            dims[0] = ca
        if ba is not None:
            for i in range(1, min(len(shape), 3)):
                if shape[i] % ba_size == 0 and shape[i] >= ba_size:
                    dims[i] = ba
                    break
        for i in range(len(shape) - 1, 1, -1):
            if dims[i] is None and shape[i] % tp_size == 0 \
                    and shape[i] >= tp_size and shape[i] > 1:
                dims[i] = tp
                break
        return tuple(dims)

    return tree_map(spec, cache_struct)


# ---------------------------------------------------------------------------
# the mixes across the ranks of a client mesh
# ---------------------------------------------------------------------------
def _schedule_offsets(schedule, m: int):
    """The mix's schedule (default: the one-peer exponential graph) and
    its validated per-round permutation offsets."""
    schedule = schedule or topology.TopologySchedule.exponential(m)
    if schedule.m != m:
        raise AssertionError((schedule.m, m))
    return schedule, schedule.permutation_offsets()


def _narrow(row: torch.Tensor, wire_dtype) -> torch.Tensor:
    return row.to(wire_dtype) if wire_dtype is not None else row


def _permute_rows(x: torch.Tensor, steps, wire_dtype, peer) -> torch.Tensor:
    """(x + recv) * 0.5 over the local rows of x, recv[i] the source row
    of `steps` (local, or received in the step's exchange; `peer` maps a
    plan's data index to its global rank).  Only the copy that is sent
    (or copied) is narrowed to wire_dtype; one row is received at a time,
    so the mix holds x, its output and one row."""
    out = torch.empty_like(x)
    for st in steps:
        sends = [(_narrow(x[i], wire_dtype), peer(q)) for i, q in st.sends]
        if st.local is None:
            got = torch.empty(x.shape[1:], device=x.device,
                              dtype=wire_dtype or x.dtype)
            ranks.exchange(sends, [(got, peer(st.peer))])
        else:
            ranks.exchange(sends, [])
            got = _narrow(x[st.local], wire_dtype)
        torch.add(x[st.row], got.to(x.dtype), out=out[st.row])
        out[st.row].mul_(0.5)
    return out


def _permute_mu(mu: torch.Tensor, steps, mesh) -> torch.Tensor:
    """(mu + mu[src]) * 0.5 per local row, mu gathered over the data group
    (the same on every model index)."""
    mu_all = ranks.all_gather_rows(mu, mesh.world, mesh.data_group)
    return torch.stack([(mu[st.row] + mu_all[st.src]) * 0.5
                        for st in steps])


def _permutation_plans(mesh, m: int, offsets):
    return [ranks.permutation_steps(m, mesh.world, mesh.data_index, off)
            for off in offsets]


def make_ppermute_mix(mesh, layout: Layout, mask, params_struct,
                      wire_dtype=None,
                      schedule: "topology.TopologySchedule | None" = None):
    """The one-peer permutation mix of the tree-form round, across the
    ranks of a client mesh (`mesh.make_host_mesh`).  The per-round offsets
    come from `schedule` (default: the one-peer exponential graph): round
    t pulls from client (j - offsets[t mod period]) mod m with weights
    (1/2, 1/2), so the push-sum weight stays 1.  Each shared leaf (the
    rank's shard of it) mixes as (a + recv) * 0.5 over the data group,
    recv narrowed to wire_dtype on the wire only; the personal part
    merges back untouched.  -> mix(params, mu, rnd, P) ->
    (params, mu); `rnd` is the state's round counter (its host value,
    `dfedpgp.host_round`, picks the offset) and P is not read."""
    m = layout.n_clients
    _, offsets = _schedule_offsets(schedule, m)
    plans = _permutation_plans(mesh, m, offsets)

    def mix(params, mu, rnd, P_unused=None):
        steps = plans[dfedpgp.host_round(rnd) % len(plans)]
        u, v = partition.split(params, mask)
        u2 = tree_map(lambda a: _permute_rows(a, steps, wire_dtype,
                                              mesh.peer), u)
        return partition.merge(u2, v), _permute_mu(mu, steps, mesh)

    return mix


def make_ppermute_mix_flat(mesh, layout: Layout, d_flat: int,
                           wire_dtype=None,
                           schedule: "topology.TopologySchedule | None"
                           = None):
    """The resident form of `make_ppermute_mix`: the rank's (m / D,
    d_flat / T) block of the buffer (its clients' rows, its columns of
    them) mixes row by row over the data group (at most one received row
    held at a time), mu with it.  -> mix(flat, mu, rnd, P) -> (flat, mu)
    for `DFedPGP(mix_fn_flat=...)`."""
    m = layout.n_clients
    _, offsets = _schedule_offsets(schedule, m)
    plans = _permutation_plans(mesh, m, offsets)

    def mix(flat, mu, rnd, P_unused=None):
        steps = plans[dfedpgp.host_round(rnd) % len(plans)]
        return (_permute_rows(flat, steps, wire_dtype, mesh.peer),
                _permute_mu(mu, steps, mesh))

    return mix


def _mix_halo(mesh, plan, P, flat, mu_all, wire_dtype):
    """The rows [plan.lo, plan.hi) of the matrix mix under the table P
    (global ids of the plan's row space): the rank receives the halo rows
    its rows read from the other ranks of its data group into a buffer
    after its own rows (one batch of point-to-point operations; without a
    halo the block itself, no copy), then mixes its rows in one
    `ops.gossip_gather` call (the kernel on the card; `mix_rows` for a
    narrowed payload, as `gossip.mix_flat`'s "sparse" mode), and mu by
    `mix_rows` over `mu_all`, the mu of every row of the space.  Wide
    tables (k >= rows) gather too: the cross-rank mix never densifies."""
    lo, hi, dev = plan.lo, plan.hi, flat.device
    x = _narrow(flat, wire_dtype)
    if plan.halo:
        ext = torch.empty((hi - lo + len(plan.halo),) + x.shape[1:],
                          dtype=x.dtype, device=dev)
        ext[:hi - lo].copy_(x)
    else:
        ext = x
    ranks.exchange(
        [(x[g - lo], mesh.peer(q)) for q, rows in plan.send for g in rows],
        [(ext[plan.position(g)], mesh.peer(q)) for q, rows in plan.recv
         for g in rows])
    idx = torch.tensor([[plan.position(int(g)) for g in row]
                        for row in P.idx[lo:hi].tolist()],
                       dtype=torch.int32).reshape(hi - lo,
                                                  P.idx.shape[1]).to(dev)
    w = P.w[lo:hi].to(dev)
    if ext.dtype == torch.float32:
        mixed = ops.gossip_gather(idx, w, ext)
    else:
        mixed = gossip.mix_rows(idx, w, ext)
    return (mixed.to(flat.dtype),
            gossip.mix_rows(P.idx[lo:hi].to(dev), w, mu_all))


def make_matrix_mix_flat(mesh, layout: Layout, wire_dtype=None):
    """The resident matrix mix across the ranks of a client mesh, under a
    SparseTopology.  mix(flat, mu, rnd, P): P is the round's FULL (m, k)
    table in global ids, on the host (every rank holds the same one, so
    each plans its peers' side, `ranks.gather_plan`).  The rank holds its
    columns of its clients' rows (`launch/tp.py`) and mixes them through
    `_mix_halo`, mu over the mu gathered from its data group."""
    m, world = layout.n_clients, mesh.world

    def mix(flat, mu, rnd, P):
        plan = ranks.gather_plan(P.idx.tolist(), m, world, mesh.data_index)
        mu_all = ranks.all_gather_rows(mu, world, mesh.data_group)
        return _mix_halo(mesh, plan, P, flat, mu_all, wire_dtype)

    return mix


def make_matrix_mix_sampled(mesh, layout: Layout, wire_dtype=None):
    """The compact-set counterpart of `make_matrix_mix_flat`: the sampled
    round's mix across the ranks of a client mesh.  mix(flat, mu, rnd,
    P_act, bounds): P_act is the round's FULL (n_active, k) induced table
    in compact ids, on the host; bounds (`ranks.compact_bounds`) say which
    compact rows each data index owns, flat and mu are the rank's own
    compact rows (its columns of them; none at all on a rank whose block
    holds no active client).  Only the active rows P_act reads cross ranks;
    mu travels as the compact mu gathered from the data group."""
    world = mesh.world

    def mix(flat, mu, rnd, P_act, bounds):
        plan = ranks.gather_plan(P_act.idx.tolist(), bounds[-1], world,
                                 mesh.data_index, bounds)
        counts = [b - a for a, b in zip(bounds, bounds[1:])]
        mu_all = ranks.all_gather_rows(mu, world, mesh.data_group, counts)
        return _mix_halo(mesh, plan, P_act, flat, mu_all, wire_dtype)

    return mix


class RankRound:
    """A client-mesh rank's part in a Regime B round beyond its resident
    mix (`DFedPGP.across_ranks`): which active clients of a sampled round
    it owns and their compact mix across its data group
    (`make_matrix_mix_sampled`), and the reductions of the round's metrics
    and gauges over the mesh: rows over the data group, split columns over
    the model group (`obs.gauges.RankGroups`), each exactly once."""

    def __init__(self, mesh, layout: Layout, executor, wire_dtype=None):
        self.mesh, self.m = mesh, layout.n_clients
        self.mix_sampled = make_matrix_mix_sampled(mesh, layout, wire_dtype)
        T = mesh.shape["model"]
        self.groups = obs_gauges.RankGroups(
            data=mesh.data_group, model=mesh.model_group if T > 1 else None,
            columns=executor.split_columns, world=mesh.world,
            index=mesh.data_index, n_rows=mesh.n_local,
            peers=tuple(mesh.peer(q) for q in range(mesh.world)),
            first=mesh.model_index == 0,
            replicated=frozenset(p for p, dim in executor.plan.items()
                                 if dim is None) if T > 1 else frozenset())

    def own(self, active):
        """-> (bounds, local rows): the sampled round's compact bounds
        (`ranks.compact_bounds`) and the rows of this rank's block that
        hold its active clients, ascending."""
        active = [int(g) for g in active]
        bounds = ranks.compact_bounds(active, self.m, self.mesh.world)
        q, lo = self.mesh.data_index, self.mesh.rows[0]
        return bounds, [g - lo for g in active[bounds[q]:bounds[q + 1]]]

    def gather_mu(self, mu: torch.Tensor, counts=None) -> torch.Tensor:
        """Every rank's mu rows in order (a collective over the data
        group; `counts` where the ranks hold unequal compact rows)."""
        return ranks.all_gather_rows(mu, self.mesh.world,
                                     self.mesh.data_group, counts)

    def metrics(self, loss_v, loss_u, mu, n: int) -> dict:
        """The round's mean losses over its n clients (the ranks' sums,
        0 where a rank has none, over n) and mu's range over the whole
        buffer."""
        g = self.groups
        losses = obs_gauges.mean_ranks(torch.stack(
            [loss_v.sum(), loss_u.sum()]), n, g)
        lo_hi = obs_gauges.max_ranks(torch.stack([-mu.min(), mu.max()]), g)
        return {"loss_v": losses[0], "loss_u": losses[1],
                "mu_min": -lo_hi[0], "mu_max": lo_hi[1]}

    def round_gauges(self, *, flat, mu, mu_pre, upd_before, upd_after,
                     grad_norms, P, n: int, active=None,
                     counts=None) -> dict:
        """`DFedPGP._round_gauges` over the mesh: the consensus gap over
        the whole buffer (`consensus_gap_ranks`), the mass ledger of the
        gathered mu (`active`: the sampled round's global ids), the update
        and gradient norms over the mesh, wire edges and moved mass of the
        host table P against the gathered pre-mix mu (`counts`: its
        compact rows per rank).  No codec runs across ranks, so no EF
        ratio."""
        g = self.groups
        dev = flat.device
        out = dict(obs_gauges.consensus_gap_ranks(flat, mu, g))
        mask = None
        if active is not None:
            mask = torch.zeros((self.m,), dtype=torch.bool, device=dev)
            mask[torch.as_tensor(active, device=dev).long()] = True
        out.update(obs_gauges.mass_ledger(self.gather_mu(mu), mask))
        out["update_norm"] = obs_gauges.update_norm_ranks(upd_before,
                                                          upd_after, g)
        out["grad_norm"] = obs_gauges.mean_ranks(grad_norms.sum(), n, g)
        P = P.to(dev)
        out["wire_edges"] = obs_gauges.wire_edges(P)
        out["moved_mass"] = obs_graph.moved_mass(
            P, self.gather_mu(mu_pre, counts))
        return out


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def _resolve_regime_b(layout: Layout, spec, gossip, schedule, resident,
                      caller: str):
    """One (gossip, schedule, resident, sample_frac) tuple for the Regime B
    step constructors.  `spec` (a repro_torch.spec.AlgoSpec) owns them: the
    schedule is `spec.schedule(layout.n_clients)`.  The legacy kwargs keep
    working (non-default uses warn); passing both raises."""
    if spec is None:
        if gossip != "matrix" or resident or schedule is not None:
            warnings.warn(
                f"{caller}(gossip=/schedule=/resident=) kwargs are "
                f"deprecated: build an AlgoSpec "
                f"(repro_torch.spec.make_algo_spec) and pass spec=",
                DeprecationWarning, stacklevel=3)
        return gossip, schedule, resident, 1.0
    clash = [k for k, v, dflt in (("gossip", gossip, "matrix"),
                                  ("schedule", schedule, None),
                                  ("resident", resident, False))
             if v != dflt]
    if clash:
        raise ValueError(
            f"{caller}(spec=...) conflicts with legacy kwarg(s) {clash}: "
            f"the spec owns them now — drop the duplicates")
    # "ppermute" is the permutation mix; every matrix engine (dense /
    # sparse / pallas) is the mixing-matrix contraction ("matrix")
    b_gossip = "ppermute" if spec.gossip == "ppermute" else "matrix"
    return (b_gossip, spec.schedule(layout.n_clients), spec.resident,
            spec.participation_frac)


def _bf16_hooks(mask):
    """The shared-part gradients cast to bf16 before the optimizer (the
    reference's bf16_grads): the tree hook casts the shared leaves with
    dims (the personal part never crosses a data shard), the row hook the
    whole (d_flat,) row, which IS the shared part."""
    def grad_hook(g):
        return tree_map(lambda x, shared: x.to(torch.bfloat16)
                        if (shared and x.dim()) else x, g, mask)

    def grad_hook_flat(g):
        return g.to(torch.bfloat16)

    return grad_hook, grad_hook_flat


def build_train_algo(cfg: ModelConfig, mesh, layout: Layout,
                     k_u: int = 1, k_v: int = 1, gossip: str = "matrix",
                     bf16_grads: bool = False, gossip_dtype: str = "",
                     schedule: "topology.TopologySchedule | None" = None,
                     resident: bool = False, lr: float = 0.1, spec=None):
    """-> (algo, mask, params_struct, flat_layout).

    The DFedPGP instance behind a Regime B round, shared by
    `build_train_step` and `launch/train.py`, so every entry point mixes over
    the same `TopologySchedule`.  `schedule` must match the layout's
    client count; `resident=True` builds the flat-buffer form
    (flat_layout: the buffer's layout, None otherwise).  params_struct is
    the stacked tree as meta tensors.  `spec` (AlgoSpec) supplies gossip /
    schedule / resident / telemetry; the kwargs are the legacy surface.

    `mesh`: None (one device: the matrix mix of `gossip.mix_flat`), or a
    client mesh (`mesh.make_host_mesh`), whose rank runs its model index's
    shard of the clients of its block (`algo.tp`, a `tp.Executor`; the
    loss is the family's on shards, `tp.ModelShards`, and the
    caller shards the init with `algo.tp.shard` / `.shard_state`):
    gossip="ppermute" then mixes through
    `make_ppermute_mix_flat` (resident) or `make_ppermute_mix` (tree
    form), gossip="matrix" through `make_matrix_mix_flat` (resident only),
    and a sampled round's compact set through `make_matrix_mix_sampled`
    (`algo.across_ranks`, a `RankRound`, which also reduces the round's
    metrics and gauges over the mesh).  gossip="ppermute" needs a client
    mesh."""
    knobs = _resolve_regime_b(layout, spec, gossip, schedule, resident,
                              "build_train_algo")
    return _train_algo(cfg, mesh, layout, knobs, spec, k_u, k_v, bf16_grads,
                       gossip_dtype, lr)


def _cross_rank_mixes(mesh, layout: Layout, gossip: str, schedule,
                      resident: bool, mask, params_struct, flat_layout,
                      wire_dtype):
    """(mix_fn, mix_fn_flat) of a Regime B round: (None, None) for the
    one-device matrix mix."""
    if gossip == "ppermute":
        if not isinstance(mesh, ClientMesh):
            raise ValueError(
                "gossip='ppermute' mixes across the ranks of a client mesh "
                "(launch.mesh.make_host_mesh); on one device use "
                "gossip='matrix'")
        if resident:
            return None, make_ppermute_mix_flat(
                mesh, layout, flat_layout.d_flat, wire_dtype=wire_dtype,
                schedule=schedule)
        return make_ppermute_mix(mesh, layout, mask, params_struct,
                                 wire_dtype=wire_dtype,
                                 schedule=schedule), None
    if not isinstance(mesh, ClientMesh):
        return None, None
    if not resident:
        raise ValueError("the matrix mix across ranks runs on the resident "
                         "buffer (resident=True); the tree-form round "
                         "across ranks mixes with gossip='ppermute'")
    return None, make_matrix_mix_flat(mesh, layout, wire_dtype=wire_dtype)


def _train_algo(cfg: ModelConfig, mesh, layout: Layout, knobs, spec,
                k_u: int, k_v: int, bf16_grads: bool, gossip_dtype: str,
                lr: float):
    """build_train_algo on resolved (gossip, schedule, resident, frac)."""
    gossip, schedule, resident, _ = knobs
    # round gauges: spec-only, as in the reference
    telemetry = spec.telemetry if spec is not None else False
    api = get_model(cfg)

    def loss_fn(p, batch):
        return api.loss_fn(p, batch, cfg)

    params_struct = stacked_param_struct(cfg, layout.n_clients)
    template = tree_map(lambda x: x[0], params_struct)
    mask = partition.build_mask(template, partition.classifier_personal)
    if schedule is not None and schedule.m != layout.n_clients:
        # a topology for another client count would mix another graph
        # than the experiment asked for (the reference's AssertionError,
        # raised so that it holds under python -O too)
        raise AssertionError(f"schedule.m={schedule.m} != "
                             f"layout.n_clients={layout.n_clients}")
    flat_layout = FlatLayout.build(params_struct, mask) if resident else None
    opt = SGD(lr=lr, momentum=0.9, weight_decay=5e-4)
    wire_dtype = getattr(torch, gossip_dtype) if gossip_dtype else None
    executor = across = None
    if isinstance(mesh, ClientMesh):
        # the cross-rank path always runs through the executor (at T = 1
        # its shards are whole leaves and its collectives one-rank copies)
        executor = tp.Executor(cfg, mesh, template, flat_layout)
        loss_fn = executor.loss_fn(api, cfg)
        across = RankRound(mesh, layout, executor, wire_dtype)
    mix_fn, mix_fn_flat = _cross_rank_mixes(
        mesh, layout, gossip, schedule, resident, mask, params_struct,
        flat_layout, wire_dtype)
    grad_hook = grad_hook_flat = None
    if bf16_grads:
        grad_hook, grad_hook_flat = _bf16_hooks(mask)
    algo = dfedpgp.DFedPGP(
        loss_fn=loss_fn, mask=mask, opt_u=opt, opt_v=opt, k_v=k_v, k_u=k_u,
        mix_fn=mix_fn, mix_fn_flat=mix_fn_flat,
        grad_hook=grad_hook, grad_hook_flat=grad_hook_flat,
        gossip_dtype=wire_dtype, telemetry=telemetry, tp=executor,
        across_ranks=across)
    return algo, mask, params_struct, flat_layout


def _topology_struct(schedule, dense_struct):
    """The round's mixing-pattern argument: the schedule's own
    SparseTopology (as meta tensors) for a schedule-driven round, the
    dense (m, m) matrix otherwise."""
    if schedule is None:
        return dense_struct
    topo0 = schedule.at(0)
    return topology.SparseTopology(_meta(topo0.idx.shape, topo0.idx.dtype),
                                   _meta(topo0.w.shape, topo0.w.dtype))


def _topology_spec(layout: Layout, P_struct, rows=None):
    """The pattern's placement: a SparseTopology's tables row-split over
    the client axes (`rows`: their entry, default the client axes), the
    dense matrix replicated."""
    if not isinstance(P_struct, topology.SparseTopology):
        return ()
    rows = axes_or_none(layout.client_axes) if rows is None else rows
    return topology.SparseTopology((rows, None), (rows, None))


def _check_sampling(sample_frac: float, resident: bool, schedule,
                    gossip: str) -> None:
    if not 0.0 < sample_frac <= 1.0:
        raise ValueError(f"sample_frac={sample_frac}; want (0, 1]")
    if sample_frac < 1.0:
        if not resident:
            raise ValueError("partial participation gathers/scatters the "
                             "resident flat buffer; pass resident=True")
        if schedule is None:
            raise ValueError("partial participation restricts a "
                             "TopologySchedule per round; pass schedule=")
        if gossip == "ppermute":
            raise ValueError("ppermute offsets address all m shards; the "
                             "sampled round mixes the compact working set "
                             "— use gossip='matrix'")


def build_train_step(cfg: ModelConfig, mesh, layout: Layout,
                     shape: InputShape, k_u: int = 1, k_v: int = 1,
                     gossip: str = "matrix", bf16_grads: bool = False,
                     gossip_dtype: str = "",
                     schedule: "topology.TopologySchedule | None" = None,
                     resident: bool = False, sample_frac: float = 1.0,
                     spec=None):
    """-> (train_step, in_shardings, out_shardings, arg_structs).

    train_step(state, P, batches) -> (state, metrics): one DFedPGP round,
    K_v personal steps, K_u shared steps at the de-biased parameters, then
    the directed push-sum mix of the shared part.  resident=True is the
    flat-buffer form (`FlatDFedPGPState`, `round_fn_flat`); a schedule
    makes P the schedule's own SparseTopology.

    sample_frac < 1 is the partial-participation step:
    train_step(state, P_act, active, batches) runs `round_fn_sampled` on
    the compact working set and writes back in place (one `gossip_scatter`
    launch on the card).  It needs resident=True and a schedule, and
    refuses gossip='ppermute'.  On a client mesh the step runs the rank's
    share: P_act and active are the round's full host table and ids, the
    batches the rank's own compact rows (`ranks.compact_bounds`), and the
    metrics come back reduced over the mesh.

    The shardings are `sharding.py` placements on `mesh` (None when
    `mesh` is None: one device); arg_structs are meta tensors of the
    step's arguments."""
    knobs = _resolve_regime_b(layout, spec, gossip, schedule, resident,
                              "build_train_algo")
    if spec is None:
        knobs = knobs[:3] + (sample_frac,)
    elif sample_frac != 1.0:
        raise ValueError(
            "build_train_step(spec=...) conflicts with legacy kwarg "
            "['sample_frac']: the spec owns participation now — drop the "
            "duplicate")
    gossip, schedule, resident, sample_frac = knobs
    # refused before the algo is built: on one device a ppermute algo
    # cannot be built at all
    _check_sampling(sample_frac, resident, schedule, gossip)
    algo, mask, params_struct, flat_layout = _train_algo(
        cfg, mesh, layout, knobs, spec, k_u, k_v, bf16_grads, gossip_dtype,
        0.1)

    specs = input_specs(cfg, shape, layout, k_u=k_u, k_v=k_v)
    P_struct = _topology_struct(schedule, specs["P"])
    metric_names = ["loss_v", "loss_u", "mu_min", "mu_max"]

    if sample_frac < 1.0:
        m = layout.n_clients
        n_act = max(1, int(round(sample_frac * m)))
        B = layout.per_client_batch
        b_struct = {"v": batch_struct(cfg, shape, (n_act, k_v, B)),
                    "u": batch_struct(cfg, shape, (n_act, k_u, B))}
        k_nb = schedule.at(0).idx.shape[1]
        P_struct = topology.SparseTopology(_meta((n_act, k_nb), torch.int32),
                                           _meta((n_act, k_nb),
                                                 torch.float32))
        act_struct = _meta((n_act,), torch.int32)
        metric_names.append("n_active")
        state_struct = algo.init_flat(params_struct, flat_layout,
                                      device=META)[0]

        def train_step(state, P_act, active, batches):
            return algo.round_fn_sampled(state, P_act, active, batches,
                                         flat_layout)

        ins, outs = (None, None, None, None), None
        if mesh is not None:
            row = sharding.sampled_buffer_spec(
                mesh, layout.client_axes, n_act, flat_layout.d_flat,
                layout.tp_axes)[0]
            st_sh = flat_state_shardings(state_struct, mesh, layout)
            ins = (st_sh, _topology_spec(layout, P_struct, row), (),
                   tree_map(lambda leaf: (row,) + (None,) * (leaf.dim() - 1),
                            b_struct))
            outs = st_sh
        return (train_step, ins, (outs, _metric_specs(mesh, metric_names)),
                (state_struct, P_struct, act_struct, b_struct))

    if resident:
        state_struct = algo.init_flat(params_struct, flat_layout,
                                      device=META)[0]

        def train_step(state, Pm, batches):
            return algo.round_fn_flat(state, Pm, batches, flat_layout)
    else:
        state_struct = algo.init(params_struct, device=META)

        def train_step(state, Pm, batches):
            return algo.round_fn(state, Pm, batches)

    ins, st_sh = (None, None, None), None
    if mesh is not None:
        st_sh = (flat_state_shardings if resident else state_shardings)(
            state_struct, mesh, layout)
        ins = (st_sh, _topology_spec(layout, P_struct),
               batch_specs(specs["batches"], mesh, layout, n_lead=2))
    return (train_step, ins, (st_sh, _metric_specs(mesh, metric_names)),
            (state_struct, P_struct, specs["batches"]))


def _metric_specs(mesh, names) -> dict:
    """Every metric a replicated scalar (None on one device)."""
    return dict.fromkeys(names, None if mesh is None else ())


def _client(tree: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], tree)


def build_prefill_step(cfg: ModelConfig, mesh, layout: Layout,
                       shape: InputShape):
    """-> (prefill_step, in_shardings, out_sharding, arg_structs).

    prefill_step(params, batch) -> (m, B, 1, vocab) logits: each client's
    `prefill_logits` on the kernel route over its slice of every batch
    entry (tokens; a vlm's vision embeddings or an encdec's frames too).
    The reference vmaps the clients; the flash kernel is a ctypes launch
    that cannot run under `torch.func.vmap`, so the clients run in a loop:
    n_layers `flash_attention` launches per client (24 x m for
    qwen2-0.5b)."""
    icfg = cfg.replace(remat=False)

    def prefill_step(params, batch):
        return torch.stack([prefill_logits(_client(params, i),
                                           _client(batch, i), icfg)
                            for i in range(batch["tokens"].shape[0])])

    params_struct = stacked_param_struct(icfg, layout.n_clients)
    specs = input_specs(icfg, shape, layout)
    ins = out = None
    if mesh is not None:
        ins = (params_shardings(params_struct, mesh, layout),
               batch_specs(specs["batch"], mesh, layout, n_lead=1))
        out = (axes_or_none(layout.client_axes),
               axes_or_none(layout.batch_axes))
    return prefill_step, ins or (None, None), out, (params_struct,
                                                    specs["batch"])


def build_decode_step(cfg: ModelConfig, mesh, layout: Layout,
                      shape: InputShape):
    """-> (serve_step, in_shardings, out_shardings, arg_structs).

    serve_step(params, cache, tokens, pos) -> (logits (m, B, 1, vocab),
    new caches): each client's `decode_step`, in a loop over the clients
    as `build_prefill_step` runs them."""
    icfg = cfg.replace(remat=False)
    api = get_model(icfg)

    def serve_step(params, cache, tokens, pos):
        outs = [api.decode_step(_client(params, i), _client(cache, i),
                                tokens[i], pos, icfg)
                for i in range(tokens.shape[0])]
        logits = torch.stack([o[0] for o in outs])
        caches = tree_map(lambda *cs: torch.stack(cs), *[o[1] for o in outs])
        return logits, caches

    params_struct = stacked_param_struct(icfg, layout.n_clients)
    specs = input_specs(icfg, shape, layout)
    ins, outs = (None, None, None, None), (None, None)
    if mesh is not None:
        c_sh = cache_shardings(specs["cache"], mesh, layout)
        ins = (params_shardings(params_struct, mesh, layout), c_sh,
               batch_specs(specs["tokens"], mesh, layout, n_lead=1), ())
        outs = ((axes_or_none(layout.client_axes),), c_sh)
    return (serve_step, ins, outs,
            (params_struct, specs["cache"], specs["tokens"], specs["pos"]))


def build_step(cfg: ModelConfig, mesh, layout: Layout, shape: InputShape,
               **kw):
    """-> (fn, in_shardings, out_shardings, arg_structs, donate_argnums).
    donate_argnums names the argument the step may consume (the state, or
    the decode cache) as the reference donates it."""
    if shape.kind == "train":
        fn, ins, outs, args = build_train_step(cfg, mesh, layout, shape, **kw)
        donate = (0,)          # state
    elif shape.kind == "prefill":
        fn, ins, outs, args = build_prefill_step(cfg, mesh, layout, shape)
        donate = ()
    else:
        fn, ins, outs, args = build_decode_step(cfg, mesh, layout, shape)
        donate = (1,)          # cache
    return fn, ins, outs, args, donate
