"""DFedPGP — Algorithm 1 (port of `repro/core/dfedpgp.py`).

Per round t, for all clients at once:
  1. z = u / mu                                     (de-bias)
  2. K_v SGD steps on the personal part v at the pinned z       (lines 5-8)
  3. K_u SGD steps on the shared row u, each gradient evaluated at
     z = u^{t,k} / mu and applied to the biased row             (lines 9-12)
  4. push/pull over the round's directed graph:  u <- P u,  mu <- P mu.

Three forms of the round, as in the reference:
- `round_fn_flat` — the resident form: the shared part lives in the
  (m, d_flat) buffer across rounds and mixes through `gossip.mix_flat`
  (the CUDA gossip_gather kernel on a GPU buffer), or through a
  `mix_fn_flat` override such as `kernel_mix.make_kernel_mix_flat`;
- `round_fn_sampled` — partial participation on the resident buffer: only
  the active rows are gathered, stepped, mixed over the induced subgraph
  and written back in place (the CUDA gossip_scatter kernel);
- `round_fn` — the tree form on the stacked params tree (`DFedPGPState`),
  one client's `local_update` vmapped over the clients, then
  `gossip.gossip_mix` or a tree `mix_fn` override.
With a wire `codec` the two resident forms cross through the codec branch
of `gossip.mix_flat` and carry its error-feedback and reference memory in
`FlatDFedPGPState.ef` / `.ref`; the tree form raises.

`telemetry=True` adds the reference's round gauges to the resident rounds'
metrics (`_round_gauges`: consensus gap, mass ledger, update and gradient
norms, wire edges, moved mass, the EF ratio): pure reads of the post-round
buffer, so the state that flows on is bit for bit the telemetry-off
state, and telemetry off runs exactly the uninstrumented round.

On a client mesh (`launch/`) each rank runs its block of the clients:
the rounds mix through a cross-rank `mix_fn` / `mix_fn_flat`, and
`across_ranks` (a `launch.steps.RankRound`) gives the sampled round its
ownership of the active rows and their compact mix across ranks, and
reduces every round's metrics and gauges over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap
from torch.utils.weak import WeakTensorKeyDictionary

from .. import compress, tree
from ..device import resolve_device, seeded_generator
from ..kernels import ops
from ..obs import gauges
from ..obs import graph as obs_graph
from ..optim import SGD, SGDState
from . import gossip, local, partition


def _check_uniform_dtype(layout) -> None:
    if len(set(layout.dtypes)) > 1:
        raise ValueError(
            f"resident flat buffer needs a uniform shared-leaf dtype (got "
            f"{sorted({str(d) for d in layout.dtypes})}); mixed-dtype "
            f"shared parts must use the tree-form round_fn")


class DFedPGPState(NamedTuple):
    """Tree-form round state.  The momentum trees have the params'
    structure: full zeros for the part the phase trains, a per-client
    scalar placeholder (m,) for the other part."""
    params: dict           # stacked (m, ...): biased u leaves + personal v
    mu: torch.Tensor       # (m,) f32 push-sum weights
    opt_u: SGDState
    opt_v: SGDState
    round: torch.Tensor    # 0-d int32


class FlatDFedPGPState(NamedTuple):
    """Resident-buffer round state."""
    flat: torch.Tensor     # (m, d_flat) biased shared buffer u
    personal: dict         # personal leaves (m, ...), pruned tree
    mu: torch.Tensor       # (m,) f32 push-sum weights
    opt_u: SGDState        # momentum: one (m, d_flat) buffer
    opt_v: SGDState        # momentum: personal-leaf tree
    round: torch.Tensor    # 0-d int32
    # wire-codec memory: the error-feedback residual and the public
    # reference copies, (m, d_flat) f32 for lossy codecs, else None
    ef: Optional[torch.Tensor] = None
    ref: Optional[torch.Tensor] = None


# stream of `device.seeded_generator` the codec draws come from
CODEC_STREAM = 3

# The round counter's value on the host, kept beside the state's 0-d
# device counter (keyed by that tensor, as the async tick keeps its host
# clock): a codec's draws and a permutation mix's offset read it without
# reading the device.  The rounds register each new counter; a counter
# made elsewhere (a restored or converted state) is read once.
_HOST_ROUNDS = WeakTensorKeyDictionary()


def host_round(rnd: torch.Tensor) -> int:
    """The host value of a state's round counter."""
    t = _HOST_ROUNDS.get(rnd)
    if t is None:
        t = _HOST_ROUNDS[rnd] = int(rnd)
    return t


def round_counter(t: int, device) -> torch.Tensor:
    """A 0-d int32 round counter holding `t` on `device`, its host value
    registered."""
    rnd = torch.full((), int(t), dtype=torch.int32, device=device)
    _HOST_ROUNDS[rnd] = int(t)
    return rnd


def _next_round(rnd: torch.Tensor) -> torch.Tensor:
    """rnd + 1, its host value registered when rnd's is known."""
    nxt = rnd + 1
    t = _HOST_ROUNDS.get(rnd)
    if t is not None:
        _HOST_ROUNDS[nxt] = t + 1
    return nxt


@dataclasses.dataclass(frozen=True)
class DFedPGP:
    loss_fn: Callable              # (params, batch) -> scalar, one client
    mask: Any                      # shared(=True)/personal partition
    opt_u: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    opt_v: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    k_v: int = 1                   # personal local steps per round
    k_u: int = 5                   # shared local steps per round
    lr_decay: float = 0.99
    # tree-form mix override (params, mu, round, P) -> (params, mu)
    mix_fn: Optional[Callable] = None
    # resident mix override (flat, mu, round, P) -> (flat, mu), e.g. the
    # dense pushsum_mix kernel of kernel_mix.make_kernel_mix_flat
    mix_fn_flat: Optional[Callable] = None
    # applied to one client's shared-part gradients before the optimizer
    # (e.g. Regime B's bf16 cast, `launch.steps.build_train_algo`): the
    # tree form's grads tree (personal leaves are scalar zeros there)
    grad_hook: Optional[Callable] = None
    # the resident twin, applied to one client's (d_flat,) gradient row.
    # Tree hooks expect per-leaf trees, so the resident rounds refuse a
    # tree hook without this one
    grad_hook_flat: Optional[Callable] = None
    # gossip payload dtype (e.g. torch.bfloat16 halves the wire bytes)
    gossip_dtype: Optional[torch.dtype] = None
    # the reference's three engines (core.gossip): "sparse" (default) —
    # mix_rows in the payload dtype, the CUDA gossip_gather kernel for an
    # f32 payload on a GPU; "dense" — the (m, m) contraction; "pallas" —
    # the f32-accumulate gather, the kernel on a GPU in every payload dtype
    gossip: str = "sparse"
    # wire codec of the resident mix (`repro_torch.compress`): lossy codecs
    # carry error-feedback and reference memory in FlatDFedPGPState.ef /
    # .ref; the identity codec is the codec-free path bit for bit.
    # Resident rounds only; mutually exclusive with gossip_dtype
    codec: Optional[Any] = None
    # consensus step of lossy codecs: the codec mix runs on (1-g) I + g P;
    # a float in (0, 1], or "auto": g = ||u|| / (||u|| + ||ef||) clipped
    # to [0.05, 1] each round (`obs.gauges.ef_signal_ratio`)
    codec_gamma: Any = 1.0
    # round gauges (repro_torch.obs) in the resident rounds' metrics;
    # the tree-form round_fn refuses them
    telemetry: bool = False
    # a client mesh rank's tensor-parallel share (`launch.tp.Executor`):
    # the resident steps run on the rank's columns of the buffer (z
    # gathered over its model group, the gradient reduce-scattered); the
    # tree form's leaves are already the rank's shards
    tp: Optional[Any] = None
    # a client mesh rank's part beyond its mix (`launch.steps.RankRound`):
    # the sampled round's own active rows and their compact mix across the
    # data group (`across_ranks.mix_sampled`), the metrics and gauges
    # reduced over the mesh.  None: one device holds every client
    across_ranks: Optional[Any] = None

    def __post_init__(self):
        if self.gossip not in gossip.MODES:
            raise ValueError(f"gossip mode {self.gossip!r}; known: "
                             f"{gossip.MODES}")

    def _lr_scale(self, rnd: torch.Tensor) -> torch.Tensor:
        # the base is filled on the device, not uploaded from the host
        return torch.full((), self.lr_decay, dtype=torch.float32,
                          device=rnd.device) ** rnd.to(torch.float32)

    # ------------------------------------------------------------------
    # tree form
    # ------------------------------------------------------------------
    def init(self, stacked_params: dict, device="cuda") -> DFedPGPState:
        """-> DFedPGPState on `device`."""
        dev = resolve_device(device)
        params = tree.tree_map(lambda a: a.to(dev), stacked_params)
        m = tree.leaves(params)[0].shape[0]

        def part_momentum(keep_shared: bool) -> SGDState:
            # full momentum only for the part this phase trains; the other
            # part gets a per-client scalar placeholder
            return SGDState(tree.tree_map(
                lambda p, shared: torch.zeros_like(p)
                if shared == keep_shared
                else torch.zeros(p.shape[:1], dtype=p.dtype, device=dev),
                params, self.mask))

        return DFedPGPState(
            params=params,
            mu=torch.ones((m,), dtype=torch.float32, device=dev),
            opt_u=part_momentum(True),
            opt_v=part_momentum(False),
            round=round_counter(0, dev))

    def local_update(self, params: dict, mu_i, opt_u: SGDState,
                     opt_v: SGDState, batches_v: dict, batches_u: dict,
                     lr_scale, step_gate_u=None):
        """One client's alternating update on its unstacked params tree
        (`round_fn` vmaps it).  batches leaves (K, B, ...); step_gate_u
        (K_u,).  -> (params, opt_u, opt_v, (loss_v, loss_u))."""
        mask = self.mask

        def debias_leaf(p, shared):
            return (p / mu_i).to(p.dtype) if shared else p

        # ---- v-steps at the pinned z^{t,0} (personal gradient only).
        # The reference steps the whole tree with the shared gradients
        # zeroed, which leaves the shared leaves and their scalar momentum
        # placeholders as they were; stepping the personal subtree alone
        # gives the same values without a gradient of every shared leaf ----
        z_u, _ = partition.split(tree.tree_map(debias_leaf, params, mask),
                                 mask)
        params_u, params_v = partition.split(params, mask)
        mom_u, mom_v = partition.split(opt_v.momentum, mask)

        def v_loss(pv, batch):
            return self.loss_fn(partition.merge(z_u, pv), batch)

        params_v, sv, loss_v = local.sgd_steps(
            v_loss, self.opt_v, params_v, SGDState(mom_v), batches_v,
            lr_scale)
        del z_u
        params = partition.merge(params_u, params_v)       # new v only
        opt_v = SGDState(partition.merge(mom_u, sv.momentum))

        # ---- u-steps: gradient at z^{t,k} = u^{t,k}/mu, applied to the
        # biased u (not differentiated through the de-bias) ----
        value_and_grad = grad_and_value(self.loss_fn)
        losses = []
        for k in range(next(iter(batches_u.values())).shape[0]):
            z_k = tree.tree_map(debias_leaf, params, mask)
            g, loss = value_and_grad(z_k, {n: a[k] for n, a in
                                           batches_u.items()})
            del z_k
            g = local.masked_grads(g, mask, True)
            if self.grad_hook is not None:
                g = self.grad_hook(g)
            p2, s2 = self.opt_u.update(g, opt_u, params, lr_scale)
            del g
            if step_gate_u is not None:
                gate = step_gate_u[k]

                def blend(new, old):
                    return tree.tree_map(
                        lambda a, b: local.blend_(gate, a, b), new, old)
                p2 = blend(p2, params)
                s2 = SGDState(blend(s2.momentum, opt_u.momentum))
            # personal leaves must not move in the u-phase
            params, opt_u = partition.where(mask, p2, params), s2
            losses.append(loss)
        return params, opt_u, opt_v, (loss_v, torch.stack(losses).mean())

    def round_fn(self, state: DFedPGPState, P, batches: dict,
                 step_gate_u=None):
        """One tree-form round.  batches: {'v': leaves (m, K_v, B, ...),
        'u': leaves (m, K_u, B, ...)}; P: the round's SparseTopology (or a
        dense (m, m) matrix) on the state's device; step_gate_u: optional
        (m, K_u) gates.  -> (new_state, metrics)."""
        if self.codec is not None:
            raise ValueError("wire codecs ride the resident flat buffer "
                             "(round_fn_flat / round_fn_sampled); the "
                             "tree-form round_fn has no payload boundary")
        if self.telemetry:
            raise ValueError("telemetry gauges read the resident "
                             "(m, d_flat) buffer (round_fn_flat / "
                             "round_fn_sampled); the tree-form round_fn "
                             "has no buffer to gauge")
        dev = state.mu.device
        lr_scale = self._lr_scale(state.round)
        if step_gate_u is None:
            m, k_u = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones((m, k_u), dtype=torch.float32,
                                     device=dev)
        params, opt_u, opt_v, (loss_v, loss_u) = vmap(
            self.local_update, in_dims=(0, 0, 0, 0, 0, 0, None, 0))(
                state.params, state.mu, state.opt_u, state.opt_v,
                batches["v"], batches["u"], lr_scale, step_gate_u)
        if self.mix_fn is not None:
            params, mu = self.mix_fn(params, state.mu, state.round, P)
        else:
            params, mu = gossip.gossip_mix(
                params, state.mu, P, self.mask, mode=self.gossip,
                wire_dtype=self.gossip_dtype)
        new_state = DFedPGPState(params, mu, opt_u, opt_v,
                                 _next_round(state.round))
        return new_state, self._metrics(loss_v, loss_u, mu)

    def eval_params(self, state: DFedPGPState) -> dict:
        """Personalized models: de-biased shared part + personal part."""
        mu = state.mu

        def debias(a, shared):
            if not shared:
                return a
            return a / mu.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)

        return tree.tree_map(debias, state.params, self.mask)

    # ------------------------------------------------------------------
    # resident flat-buffer form
    # ------------------------------------------------------------------
    def init_flat(self, stacked_params: dict,
                  layout: Optional[gossip.FlatLayout] = None,
                  device="cuda"):
        """-> (FlatDFedPGPState, FlatLayout) on `device`.  Packs the shared
        part once; every later round operates on the resident buffer."""
        dev = resolve_device(device)
        params = tree.tree_map(lambda a: a.to(dev), stacked_params)
        fcs, layout = gossip.FlatClientState.create(params, self.mask,
                                                    layout)
        _check_uniform_dtype(layout)
        self._check_codec()
        m = fcs.flat.shape[0]
        return FlatDFedPGPState(
            flat=fcs.flat,
            personal=fcs.personal,
            mu=torch.ones((m,), dtype=torch.float32, device=dev),
            opt_u=SGDState(torch.zeros_like(fcs.flat)),
            opt_v=SGDState(tree.tree_map(torch.zeros_like, fcs.personal)),
            round=round_counter(0, dev),
            ef=compress.init_ef(self.codec, fcs.flat),
            ref=compress.init_ref(self.codec, fcs.flat),
        ), layout

    def _check_codec(self) -> None:
        """The reference's build-time validation of the codec knobs."""
        if self.codec is not None and self.mix_fn_flat is not None:
            raise ValueError("codec and mix_fn_flat are mutually "
                             "exclusive: the codec path owns the wire "
                             "crossing (gossip.mix_flat) — a mix override "
                             "would bypass the error-feedback ledger")
        if isinstance(self.codec_gamma, str):
            if self.codec_gamma != "auto":
                raise ValueError(
                    f"codec_gamma must be a float in (0, 1] or 'auto'; "
                    f"got {self.codec_gamma!r}")
            if self.codec is None or self.codec.exact:
                raise ValueError(
                    "codec_gamma='auto' anneals the lossy-codec consensus "
                    "step; the exact/uncompressed mix never blends (drop "
                    "the knob or use a lossy codec)")
            if self.gossip_dtype is not None:
                raise ValueError("codec and gossip_dtype are mutually "
                                 "exclusive: the codec IS the wire format")
            return
        g = float(self.codec_gamma)
        if self.codec is None or self.codec.exact:
            if g != 1.0:
                raise ValueError(
                    f"codec_gamma={g} only applies to lossy codecs; the "
                    f"exact/uncompressed mix never blends (drop the knob "
                    f"or use a lossy codec)")
            if self.codec is None:
                return
        if self.gossip_dtype is not None:
            raise ValueError("codec and gossip_dtype are mutually "
                             "exclusive: the codec IS the wire format")
        if not 0.0 < g <= 1.0:
            raise ValueError(f"codec_gamma must be in (0, 1], got "
                             f"{self.codec_gamma}")

    def _gamma_value(self, flat, ef):
        """The round's consensus step: the static knob as-is, or for "auto"
        a 0-d f32 tensor, `ef_signal_ratio(flat, ef)` clipped to
        [0.05, 1] — exactly 1.0 with a zero residual."""
        if not isinstance(self.codec_gamma, str):
            return self.codec_gamma
        return torch.clamp(gauges.ef_signal_ratio(flat, ef), 0.05, 1.0)

    def _codec_mix(self, P, flat, mu, ef, ref, rnd):
        """The codec crossing of a resident round -> (flat, mu, ef, ref).
        A randomized codec draws from a generator on the buffer's device
        seeded by (codec.seed, round), the port's fold_in of the round
        into the codec's key; the round is the counter's host value
        (`host_round`), so the round reads nothing from the device."""
        key = None
        if self.codec.draws:
            key = seeded_generator(self.codec.seed, CODEC_STREAM,
                                   host_round(rnd), flat.device)
        return gossip.mix_flat(P, flat, mu, mode=self.gossip,
                               codec=self.codec, ef=ef, ref=ref, key=key,
                               codec_gamma=self._gamma_value(flat, ef))

    def _v_steps(self, flat, personal, mu, opt_v, batches_v, lr_scale,
                 layout: gossip.FlatLayout):
        """Every client's K_v personal steps at the pinned z^{t,0} = u/mu
        (personal gradient only).  batches_v leaves (m, K_v, B, ...);
        lr_scale (m,).  -> (personal, opt_v, (m,) mean loss)."""
        tp = self.tp
        z0 = self._z(flat, mu)

        def v_loss(pv, batch, z_row):
            shared = layout.unravel_row(z_row)
            if tp is not None:
                shared = tp.shard_row(shared)
            return self.loss_fn(partition.merge(shared, pv), batch)

        def client_v(pv, sv, bv, z_row, ls):
            return local.sgd_steps(v_loss, self.opt_v, pv, sv, bv, ls,
                                   extra=(z_row,))

        return vmap(client_v)(personal, opt_v, batches_v, z0, lr_scale)

    def _u_step(self, flat, personal, mu, opt_u, batch, lr_scale,
                layout: gossip.FlatLayout, grad_norm: bool = False):
        """One shared step of every client: the gradient at z = u/mu,
        applied to the biased row (not differentiated through the
        de-bias).  batch leaves (m, B, ...); lr_scale (m,).  -> (flat,
        opt_u, (m,) loss), and with grad_norm the (m,) f32 norm of each
        client's gradient row (what the optimizer consumed) — read after
        the update, so the step's arithmetic is the same.  With `tp` the
        rows are the rank's columns: the gradient is taken at the gathered
        z and reduced onto them (`launch.tp.Executor.finish_grad`)."""
        tp = self.tp
        value_and_grad_u = vmap(grad_and_value(local.flat_view_loss(
            self.loss_fn, layout, None if tp is None else tp.shard_row)))
        z = self._z(flat, mu)
        g, loss = value_and_grad_u(z, personal, batch)
        del z
        if tp is not None:
            g = tp.finish_grad(g)
        if self.grad_hook_flat is not None or self.grad_hook is not None:
            g = vmap(self._apply_flat_grad_hook)(g)
        flat2, s2 = self.opt_u.update(g, opt_u, flat, lr_scale[:, None])
        if grad_norm:
            return flat2, s2, loss, (gauges.l2_norm(g, dim=1)
                                     if tp is None else tp.row_norms(g))
        return flat2, s2, loss

    def _z(self, flat, mu):
        """z = u / mu of the resident rows, gathered into whole rows over
        the model group with `tp`."""
        if self.tp is not None:
            return self.tp.gather_z(flat, mu)
        return (flat / mu[:, None]).to(flat.dtype)

    def _apply_flat_grad_hook(self, g):
        """The hook of one client's (d_flat,) gradient row: grad_hook_flat,
        else the tree hook for callers that drive the steps directly with a
        row-shaped hook (the resident rounds refuse a lone tree hook,
        `_check_flat_hooks`)."""
        if self.grad_hook_flat is not None:
            return self.grad_hook_flat(g)
        return self.grad_hook(g)

    def _check_flat_hooks(self) -> None:
        if self.grad_hook is not None and self.grad_hook_flat is None:
            raise ValueError("grad_hook expects tree-form shared-part "
                             "gradients; provide grad_hook_flat (the "
                             "(d_flat,) row form) or use the tree-form "
                             "round_fn")

    def local_update_flat(self, flat, personal, mu, opt_u, opt_v,
                          batches_v, batches_u, lr_scale, step_gate_u,
                          layout: gossip.FlatLayout):
        """All clients' alternating update on the resident buffer.
        flat: (m, d_flat) biased rows; personal: stacked personal leaves;
        batches leaves (m, K, B, ...); lr_scale: 0-d or (m,);
        step_gate_u: (m, K_u) in {0, 1}.  -> (flat, personal, opt_u,
        opt_v, (loss_v, loss_u)) with (m,) per-client mean losses, and
        with telemetry a third (m,) entry, each client's gradient norm
        averaged over its u-steps.  The steps are `_v_steps` and
        `_u_step`, the functions the async tick (`tick_update_flat`) runs
        one at a time."""
        m = flat.shape[0]
        lr_scale = torch.as_tensor(lr_scale, dtype=torch.float32,
                                   device=flat.device).expand(m)
        # ---- v-steps at the pinned z^{t,0}; K_v = 0 skips the phase ----
        if local.n_steps(batches_v) == 0:
            loss_v = torch.zeros((m,), dtype=torch.float32,
                                 device=flat.device)
        else:
            personal, opt_v, loss_v = self._v_steps(
                flat, personal, mu, opt_v, batches_v, lr_scale, layout)

        # ---- u-steps: gradient at z^{t,k} = u^{t,k}/mu, applied to the
        # biased row; a step gate of 1 keeps the step bit for bit ----
        losses, norms = [], []
        for k in range(local.n_steps(batches_u)):
            flat2, s2, loss, *norm = self._u_step(
                flat, personal, mu, opt_u, local.step_batch(batches_u, k),
                lr_scale, layout, grad_norm=self.telemetry)
            gate = step_gate_u[:, k:k + 1]
            flat = local.blend_(gate, flat2, flat)
            opt_u = SGDState(local.blend_(gate, s2.momentum,
                                          opt_u.momentum))
            del flat2, s2
            losses.append(loss)
            norms += norm
        loss_u = torch.stack(losses, dim=1).mean(dim=1)
        if self.telemetry:
            return flat, personal, opt_u, opt_v, (
                loss_v, loss_u, torch.stack(norms, dim=1).mean(dim=1))
        return flat, personal, opt_u, opt_v, (loss_v, loss_u)

    def tick_update_flat(self, flat, personal, mu, opt_u, opt_v, batch,
                         in_v_phase, lr_scale, layout: gossip.FlatLayout,
                         has_v_phase: bool = True):
        """ONE tick of the alternating update for every client — the async
        runtime's step (`hetero.runtime`).  batch leaves (m, B, ...);
        in_v_phase (m,) bool; lr_scale (m,).

        Computes one v-step (`_v_steps` over a single step: u does not move
        in the v-phase, so de-biasing the CURRENT row is the z^{t,0} pin)
        and one u-step (`_u_step`) for every client, then selects per
        client with `torch.where` on in_v_phase.  The branches touch
        disjoint state, so k_v v-ticks then k_u u-ticks are bit for bit
        one `local_update_flat` on the same batches.  has_v_phase False
        (k_v = 0: the full-model cores of async OSGP / DFedAvgM) skips the
        v branch.  -> (flat, personal, opt_u, opt_v, (m,) loss)."""
        row2, su2, loss_u = self._u_step(flat, personal, mu, opt_u, batch,
                                         lr_scale, layout)
        if not has_v_phase:
            return row2, personal, su2, opt_v, loss_u
        one_step = {k: a[:, None] for k, a in batch.items()}
        pv2, sv2, loss_v = self._v_steps(flat, personal, mu, opt_v,
                                         one_step, lr_scale, layout)

        def sel(a, b):
            return torch.where(in_v_phase.reshape((-1,) + (1,) * (a.dim()
                                                                  - 1)),
                               a, b)
        return (sel(flat, row2), tree.tree_map(sel, pv2, personal),
                SGDState(sel(opt_u.momentum, su2.momentum)),
                SGDState(tree.tree_map(sel, sv2.momentum, opt_v.momentum)),
                sel(loss_v, loss_u))

    def round_fn_flat(self, state: FlatDFedPGPState, P, batches: dict,
                      layout: gossip.FlatLayout, step_gate_u=None):
        """One resident round: local steps on all clients, then the
        push-pull mixes the buffer (`gossip.mix_flat`, or the
        `mix_fn_flat` override).  batches: {'v': leaves (m, K_v, B, ...),
        'u': leaves (m, K_u, B, ...)}; P: the round's SparseTopology on the
        state's device (or a dense (m, m) matrix).  -> (new_state,
        metrics)."""
        if self.mix_fn is not None and self.mix_fn_flat is None:
            raise ValueError("mix_fn overrides operate on tree-form "
                             "leaves; the resident path mixes the flat "
                             "buffer directly — provide mix_fn_flat "
                             "(kernel_mix.make_kernel_mix_flat) or use the "
                             "tree-form round_fn")
        self._check_flat_hooks()
        lr_scale = self._lr_scale(state.round)
        if step_gate_u is None:
            m, k_u = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones((m, k_u), dtype=torch.float32,
                                     device=state.flat.device)
        flat, personal, opt_u, opt_v, aux = \
            self.local_update_flat(state.flat, state.personal, state.mu,
                                   state.opt_u, state.opt_v, batches["v"],
                                   batches["u"], lr_scale, step_gate_u,
                                   layout)
        loss_v, loss_u = aux[0], aux[1]
        flat_local = flat     # post-local / pre-mix buffer (update gauge)
        ef, ref = state.ef, state.ref
        if self.mix_fn_flat is not None:
            flat, mu = self.mix_fn_flat(flat, state.mu, state.round, P)
        elif self.codec is not None:
            flat, mu, ef, ref = self._codec_mix(P, flat, state.mu, ef, ref,
                                                state.round)
        else:
            flat, mu = gossip.mix_flat(P, flat, state.mu, mode=self.gossip,
                                       wire_dtype=self.gossip_dtype)
        new_state = FlatDFedPGPState(flat, personal, mu, opt_u, opt_v,
                                     _next_round(state.round), ef, ref)
        metrics = self._metrics(loss_v, loss_u, mu)
        if self.telemetry:
            metrics.update(self._round_gauges(
                flat=flat, mu=mu, mu_pre=state.mu, upd_before=state.flat,
                upd_after=flat_local, ef_pre=state.ef, grad_norms=aux[2],
                P=P))
        return new_state, metrics

    def _metrics(self, loss_v, loss_u, mu, n: Optional[int] = None) -> dict:
        """A round's mean losses over its clients' (n,) losses and the mu
        range of the whole buffer; on a client mesh over every rank's
        clients (`across_ranks.metrics`; n of them, default all)."""
        if self.across_ranks is None:
            return {"loss_v": loss_v.mean(), "loss_u": loss_u.mean(),
                    "mu_min": mu.min(), "mu_max": mu.max()}
        return self.across_ranks.metrics(
            loss_v, loss_u, mu, self.across_ranks.m if n is None else n)

    def _round_gauges(self, *, flat, mu, mu_pre, upd_before, upd_after,
                      ef_pre, grad_norms, P, active=None, n=None,
                      counts=None) -> dict:
        """The telemetry pack of the resident rounds: 0-d reductions over
        the post-round buffer — consensus gap, mass ledger, update and
        gradient norms (`grad_norms`: each stepped client's), wire edges,
        moved mass (over the PRE-mix mu, the mass in motion this round),
        and with codec memory the EF signal ratio of the post-local buffer
        against the residual the mix is about to drain.  Never touches the
        state that flows on.  `active`: a sampled round's active rows (the
        ledger's active mask).  On a client mesh
        `across_ranks.round_gauges` reduces them over the ranks (`active`
        then the round's global ids, `n` its clients, `counts` its compact
        rows per rank)."""
        if self.across_ranks is not None:
            r = self.across_ranks
            return r.round_gauges(
                flat=flat, mu=mu, mu_pre=mu_pre, upd_before=upd_before,
                upd_after=upd_after, grad_norms=grad_norms, P=P,
                n=r.m if n is None else n, active=active, counts=counts)
        active_mask = None
        if active is not None:
            active_mask = torch.zeros(mu.shape, dtype=torch.bool,
                                      device=mu.device).index_fill_(
                0, active, True)
        g = dict(gauges.consensus_gap(flat, mu))
        g.update(gauges.mass_ledger(mu, active_mask))
        g["update_norm"] = gauges.buffer_update_norm(upd_before, upd_after)
        g["grad_norm"] = grad_norms.mean()
        g["wire_edges"] = gauges.wire_edges(P)
        g["moved_mass"] = obs_graph.moved_mass(P, mu_pre)
        if ef_pre is not None:
            g["ef_ratio"] = gauges.ef_signal_ratio(upd_after, ef_pre)
        return g

    def round_fn_sampled(self, state: FlatDFedPGPState, P_act, active,
                         batches: dict, layout: gossip.FlatLayout,
                         step_gate_u=None):
        """Partial-participation resident round: only the `active` clients
        act.  Their rows are gathered from the resident buffers, the usual
        local steps and the mix over `P_act` run on the compact
        (n_active, d_flat) working set, and the results go back.

        P_act: the round's topology restricted to the active subset, in
        compact ids (`topology.induced_subgraph(..., "row")`), on the
        state's device.  active: (n_active,) unique global ids, sorted (the
        sampler's output).  batches and step_gate_u are compact: leaves
        lead with (n_active, K, ...).

        On a client mesh (`across_ranks`) the state is the rank's block
        and P_act and active are the round's whole host table and ids, the
        same on every rank; batches and step_gate_u hold the rank's own
        compact rows, [a_q, a_{q+1}) of `launch.ranks.compact_bounds`
        (perhaps none).  The rank steps the active rows of its block, mixes
        them across its data group (`across_ranks.mix_sampled`, which never
        densifies) and writes them back into its block; the metrics and
        gauges reduce over the mesh.

        IN PLACE: `state.flat`, `state.opt_u.momentum` and, with a lossy
        codec, `state.ef` and `state.ref` are written through one
        `kernels.ops.gossip_scatter_many` call (one launch of the CUDA
        kernel on a GPU where they share a dtype) and are the new state's
        buffers too — the torch form of the
        reference's aliased, donated buffers.  A caller that needs the old
        state clones it first.  mu, the personal leaves and opt_v are
        small and are copied (`index_copy`).  Dormant rows never move.
        Metrics are means over the active clients; the mu range spans the
        whole buffer."""
        across = self.across_ranks
        if self.mix_fn is not None or (self.mix_fn_flat is not None
                                       and across is None):
            raise ValueError(
                "mix overrides operate on the full resident buffer; the "
                "sampled round mixes the compact working set — drop the "
                "override or use round_fn_flat")
        if across is not None and self.codec is not None:
            raise ValueError("no wire codec runs across ranks: the sampled "
                             "round across ranks mixes uncompressed")
        self._check_flat_hooks()
        dev = state.flat.device
        lr_scale = self._lr_scale(state.round)
        bounds = counts = None
        if across is None:
            active = torch.as_tensor(active, device=dev).to(torch.int32)
            n_act = int(active.shape[0])
        else:
            global_ids = active
            bounds, own = across.own(active)
            counts = [b - a for a, b in zip(bounds, bounds[1:])]
            n_act = bounds[-1]
            active = torch.tensor(own, dtype=torch.int32, device=dev)
        idx = active.long()
        if step_gate_u is None:
            shp = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones(shp, dtype=torch.float32, device=dev)

        def take(t):
            return t.index_select(0, idx)

        flat_pre = take(state.flat)     # gathered pre-local rows
        mu_pre = take(state.mu)
        personal_a = tree.tree_map(take, state.personal)
        opt_u_a = SGDState(take(state.opt_u.momentum))
        opt_v_a = SGDState(tree.tree_map(take, state.opt_v.momentum))
        if idx.shape[0]:
            flat_a, personal_a, opt_u_a, opt_v_a, aux = \
                self.local_update_flat(
                    flat_pre, personal_a, mu_pre, opt_u_a, opt_v_a,
                    batches["v"], batches["u"], lr_scale, step_gate_u,
                    layout)
        else:
            # a rank whose block holds no active client steps nothing
            # (every model rank of its data index alike) but still enters
            # the mix and the reductions of its data group
            flat_a = flat_pre
            aux = (torch.zeros((0,), dtype=torch.float32, device=dev),) * 3
        loss_v, loss_u = aux[0], aux[1]
        flat_local = flat_a   # post-local / pre-mix compact rows
        if self.codec is not None:
            # codec memory (None for an exact codec) rides with its rows
            ef_pre, ref_a = (None if t is None else take(t)
                             for t in (state.ef, state.ref))
            flat_a, mu_a, ef_a, ref_a = self._codec_mix(
                P_act, flat_a, mu_pre, ef_pre, ref_a, state.round)
        elif across is not None:
            ef_pre = ef_a = ref_a = None
            flat_a, mu_a = across.mix_sampled(flat_a, mu_pre, state.round,
                                              P_act, bounds)
        else:
            ef_pre = ef_a = ref_a = None
            flat_a, mu_a = gossip.mix_flat(P_act, flat_a, mu_pre,
                                           mode=self.gossip,
                                           wire_dtype=self.gossip_dtype)

        def put(full, new):
            return torch.index_copy(full, 0, idx, new)

        # the big buffers go back in one launch per (X, U) dtype pair: one
        # launch when they share a dtype (flat, momentum, ef and ref in f32)
        back = [(flat_a, state.flat), (opt_u_a.momentum,
                                       state.opt_u.momentum)]
        back += [(x, u) for x, u in ((ef_a, state.ef), (ref_a, state.ref))
                 if x is not None]
        groups: dict = {}
        for x, u in back:
            groups.setdefault((x.dtype, u.dtype), []).append((x, u))
        for pairs in groups.values():
            ops.gossip_scatter_many(active, *zip(*pairs))
        flat, opt_u, ef, ref = state.flat, state.opt_u, state.ef, state.ref
        mu = put(state.mu, mu_a)
        personal = tree.tree_map(put, state.personal, personal_a)
        opt_v = SGDState(tree.tree_map(put, state.opt_v.momentum,
                                       opt_v_a.momentum))
        new_state = FlatDFedPGPState(flat, personal, mu, opt_u, opt_v,
                                     _next_round(state.round), ef, ref)
        metrics = self._metrics(loss_v, loss_u, mu, n_act)
        metrics["n_active"] = n_act
        if self.telemetry:
            # the ledger and the consensus gap span the FULL buffer, the
            # dormant rows' share visible
            gauge_kw = dict(active=idx) if across is None else \
                dict(active=global_ids, n=n_act, counts=counts)
            metrics.update(self._round_gauges(
                flat=flat, mu=mu, mu_pre=mu_pre, upd_before=flat_pre,
                upd_after=flat_local, ef_pre=ef_pre, grad_norms=aux[2],
                P=P_act, **gauge_kw))
        return new_state, metrics

    def eval_params_flat(self, state: FlatDFedPGPState,
                         layout: gossip.FlatLayout) -> dict:
        """Personalized models: de-bias the buffer, unravel, merge
        personal."""
        z = state.flat / state.mu[:, None].to(state.flat.dtype)
        return gossip.FlatClientState(z, state.personal).to_tree(layout)

    # ------------------------------------------------------------------
    # conversion between the forms
    # ------------------------------------------------------------------
    def state_to_flat(self, state: DFedPGPState,
                      layout: Optional[gossip.FlatLayout] = None):
        """Tree-form -> resident state, -> (FlatDFedPGPState, layout)."""
        fcs, layout = gossip.FlatClientState.create(state.params, self.mask,
                                                    layout)
        _check_uniform_dtype(layout)
        self._check_codec()
        mom, _ = gossip.FlatClientState.create(state.opt_u.momentum,
                                               self.mask, layout)
        mom_v = partition.split(state.opt_v.momentum, self.mask)[1]
        # tree-form states carry no codec memory: a lossy codec starts from
        # fresh error-feedback and reference buffers
        return FlatDFedPGPState(fcs.flat, fcs.personal, state.mu,
                                SGDState(mom.flat), SGDState(mom_v),
                                state.round,
                                compress.init_ef(self.codec, fcs.flat),
                                compress.init_ref(self.codec, fcs.flat)
                                ), layout

    def state_from_flat(self, fstate: FlatDFedPGPState,
                        layout: gossip.FlatLayout) -> DFedPGPState:
        """Resident -> tree-form state.  The other part's momentum slots
        come back as the (m,) zero placeholders `init` creates."""
        params = gossip.FlatClientState(fstate.flat,
                                        fstate.personal).to_tree(layout)
        m = fstate.mu.shape[0]

        def placeholders(keep_shared: bool) -> dict:
            return tree.from_paths(
                (p, torch.zeros((m,), dtype=leaf.dtype, device=leaf.device))
                for p, leaf in tree.paths(params)
                if tree.get(self.mask, p) != keep_shared)

        mom_u = partition.merge(layout.unravel(fstate.opt_u.momentum),
                                placeholders(True))
        mom_v = partition.merge(fstate.opt_v.momentum, placeholders(False))
        return DFedPGPState(params, fstate.mu, SGDState(mom_u),
                            SGDState(mom_v), fstate.round)
