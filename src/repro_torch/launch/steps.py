"""Step constructors and input structs of Regime B (port of
`repro/launch/steps.py`).

Regime B: each client of the paper's decentralized directed gossip holds
its own personalized transformer LM.  The client axis is a real leading
axis of every parameter; the push-sum gossip of the shared part `u` is
the mixing-matrix contraction over the run's `TopologySchedule` (on the
resident (m, d_flat) buffer, the `gossip_gather` kernel on the card).

One card is one device, so every client lives on it.  What the
reference derives for a device mesh is kept where it is pure arithmetic
on the mesh's axis names and sizes (`Layout`, `decide_layout`, read from
a `mesh.MeshSpec`); placements are not: the sharding entries of the
`build_*_step` tuples are None, and the `shard_map` + `ppermute`
mixes raise, until ROADMAP item 14b ports them onto `torch.distributed`.
Where the reference builds `jax.ShapeDtypeStruct`s, the port builds
tensors on the "meta" device (shapes and dtypes, no data).

Layouts (from the reference; only their arithmetic runs here):
- ``data_clients`` (default): clients over ('pod', 'data'); TP 'model'.
- ``fsdp``: one client FSDP-sharded over 'data' and TP-sharded over
  'model', for deepseek-v2-236b (one pod per client on the multi-pod
  mesh) and for long_500k decode (global batch 1 cannot feed 16 clients).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import torch

from ..configs import InputShape
from ..core import dfedpgp, partition, topology
from ..core.gossip import FlatLayout
from ..models import get_model, prefill_logits
from ..models.config import ModelConfig
from ..optim import SGD
from ..tree import tree_map

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
    f32 take its first n_vision_tokens positions and the text the rest."""
    get_model(cfg)        # raises for the families still to port
    lead = tuple(lead)
    S = shape.seq_len
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        return {"tokens": _meta(lead + (S - nv,), torch.int64),
                "vision": _meta(lead + (nv, cfg.d_model), torch.float32),
                "labels": _meta(lead + (S - nv,), torch.int64)}
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
        shapes = tree_map(lambda a: (tuple(a.shape), a.dtype), one)
    return tree_map(lambda sd: _meta((m,) + sd[0], sd[1]), shapes)


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
    `mesh` is unused on one device (None)."""
    knobs = _resolve_regime_b(layout, spec, gossip, schedule, resident,
                              "build_train_algo")
    return _train_algo(cfg, layout, knobs, spec, k_u, k_v, bf16_grads,
                       gossip_dtype, lr)


def _train_algo(cfg: ModelConfig, layout: Layout, knobs, spec, k_u: int,
                k_v: int, bf16_grads: bool, gossip_dtype: str, lr: float):
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
    if gossip == "ppermute":
        raise NotImplementedError(
            "gossip='ppermute': the shard_map + ppermute permutation mix "
            "runs over a device mesh and is not ported yet (ROADMAP item "
            "14b); on one device use gossip='matrix'")
    grad_hook = grad_hook_flat = None
    if bf16_grads:
        grad_hook, grad_hook_flat = _bf16_hooks(mask)
    algo = dfedpgp.DFedPGP(
        loss_fn=loss_fn, mask=mask, opt_u=opt, opt_v=opt, k_v=k_v, k_u=k_u,
        grad_hook=grad_hook, grad_hook_flat=grad_hook_flat,
        gossip_dtype=getattr(torch, gossip_dtype) if gossip_dtype else None,
        telemetry=telemetry)
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
    refuses gossip='ppermute'.

    The shardings are None (one device, until ROADMAP item 14b);
    arg_structs are meta tensors of the step's arguments."""
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
        cfg, layout, knobs, spec, k_u, k_v, bf16_grads, gossip_dtype, 0.1)

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

        return (train_step, (None, None, None, None),
                (None, dict.fromkeys(metric_names)),
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

    return (train_step, (None, None, None),
            (None, dict.fromkeys(metric_names)),
            (state_struct, P_struct, specs["batches"]))


def _client(tree: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], tree)


def build_prefill_step(cfg: ModelConfig, mesh, layout: Layout,
                       shape: InputShape):
    """-> (prefill_step, in_shardings, out_sharding, arg_structs).

    prefill_step(params, batch) -> (m, B, 1, vocab) logits: each client's
    `prefill_logits` on the kernel route over its slice of every batch
    entry (tokens; a vlm's vision embeddings too).  The reference vmaps the
    clients; the flash kernel is a ctypes launch that cannot run under
    `torch.func.vmap`, so the clients run in a loop: n_layers
    `flash_attention` launches per client (24 x m for qwen2-0.5b)."""
    icfg = cfg.replace(remat=False)

    def prefill_step(params, batch):
        return torch.stack([prefill_logits(_client(params, i),
                                           _client(batch, i), icfg)
                            for i in range(batch["tokens"].shape[0])])

    params_struct = stacked_param_struct(icfg, layout.n_clients)
    specs = input_specs(icfg, shape, layout)
    return (prefill_step, (None, None), None,
            (params_struct, specs["batch"]))


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
    return (serve_step, (None, None, None, None), (None, None),
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
